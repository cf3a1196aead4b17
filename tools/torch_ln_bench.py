#!/usr/bin/env python3
"""The LayerNorm kernel (row 14) on the card, with the fused LN forward
(row 7) timed beside it as a control.

    python3 tools/torch_ln_bench.py [--root DIR]

Times with CUDA events, L2 flushed before each call
(``chip_smoke.time_cold``), at BERT-base's width C = 768:

* ``layer_norm_2d`` at 1024 rows (the embeddings of an encoder batch of 8,
  and the smoke's timed shape), 4096 (a batch of 32: encoder bucket 32 and
  the training step's embeddings) and 614 (the training step's masked-LM
  transform, 15% of 32 x 128 tokens), against ``F.layer_norm``, with the
  bytes bound at 3.35 TB/s;
* ``fused_ln_fwd`` at [4096, 768], p = 0 and p = 0.1, against
  ``F.layer_norm(x + y)`` (and with ``F.dropout(y)``);
* the floor of a cold-L2 timing on the card: a one-element add timed the
  same way.

``--root DIR`` times the kernels of the checkout at DIR (for example a
parent commit unpacked under build/, or a copy of the source with one
part changed), so that two trees can be timed in turns in one call to
the card.  Ends with one JSON line of the readings.
Needs one CUDA card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 768


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose kernels are timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the kernels on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import fused_ln as fl
    from paddle_tpu_torch.kernels import layer_norm as ln

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    print("kernels of %s" % os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(ln.__file__)))), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32)).to(dev)
    ln_f = torch.nn.functional.layer_norm
    tiny = torch.zeros(1, device=dev)
    floor_ms = smoke.time_cold(lambda: tiny.add_(1.0), flush)
    print("floor (a one-element add, timed as the kernels are) %.6f ms"
          % floor_ms, flush=True)
    rows = [{"kernel": "floor", "ms": floor_ms}]
    g, b = t(C), t(C)
    for n in (1024, 4096, 614):
        x = t(n, C)
        err = max(float((u - w).abs().max()) for u, w in zip(
            ln.layer_norm_2d(x, g, b, 1e-5),
            ln.layer_norm_2d_reference(x, g, b, 1e-5)))
        nbytes = 4 * (2 * n * C + 2 * C + 2 * n)
        row = {"kernel": "layer_norm", "rows": n, "cols": C,
               "ms": smoke.time_cold(
                   lambda: ln.layer_norm_2d(x, g, b, 1e-5), flush),
               "library_ms": smoke.time_cold(
                   lambda: ln_f(x, (C,), g, b, 1e-5), flush),
               "bound_ms": smoke.bound(nbytes, 8 * n * C)[0],
               "max_abs_err": err}
        print("layer_norm [%d, %d]: kernel %.6f ms, F.layer_norm %.6f, "
              "bound %.6f (bytes), err vs plain %.3g" % (
                  n, C, row["ms"], row["library_ms"], row["bound_ms"], err),
              flush=True)
        rows.append(row)
    n = 4096
    x, y = t(n, C), t(n, C)
    drop_f = torch.nn.functional.dropout
    for p in (0.0, 0.1):
        words = smoke.WORDS if p else None
        row = {"kernel": "fused_ln", "rows": n, "cols": C, "p": p,
               "ms": smoke.time_cold(
                   lambda: fl.fused_ln_fwd(x, y, g, b, p, words, 1e-5),
                   flush),
               "library_ms": smoke.time_cold(
                   lambda: ln_f(x + (drop_f(y, p) if p else y), (C,), g, b,
                                1e-5), flush),
               "bound_ms": smoke.bound(4 * (4 * n * C + 2 * C + 2 * n),
                                       9 * n * C)[0]}
        print("fused_ln [%d, %d] p=%g: kernel %.6f ms, F.layer_norm(x + y%s) "
              "%.6f, bound %.6f (bytes)" % (
                  n, C, p, row["ms"], ", dropped" if p else "",
                  row["library_ms"], row["bound_ms"]), flush=True)
        rows.append(row)
    print(json.dumps({"ln_bench": rows}), flush=True)


if __name__ == "__main__":
    main()
