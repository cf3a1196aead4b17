#!/usr/bin/env python3
"""The LayerNorm kernel (row 14) and the fused LN backward (row 8) on the
card, with the fused LN forward (row 7) timed beside them.

    python3 tools/torch_ln_bench.py [--root DIR]

Times with CUDA events, L2 flushed before each call
(``chip_smoke.time_cold``), at BERT-base's width C = 768:

* ``layer_norm_2d`` at 1024 rows (the embeddings of an encoder batch of 8,
  and the smoke's timed shape), 4096 (a batch of 32: encoder bucket 32 and
  the training step's embeddings) and 614 (the training step's masked-LM
  transform, 15% of 32 x 128 tokens), against ``F.layer_norm``, with the
  bytes bound at 3.35 TB/s;
* ``fused_ln_fwd`` at [128, 768], [1024, 768] and [4096, 768] (encoder
  buckets 1, 8 and 32, and the training step's rows), p = 0 and p = 0.1,
  against ``F.layer_norm(x + y)`` (and with ``F.dropout(y)``), with the
  bytes bound;
* the dropout op's kernel at the attention probabilities' [32, 12, 128,
  128], p = 0.1, against ``F.dropout``;
* ``fused_ln_bwd`` at [4096, 768] (the 24 encoder epilogues of a BERT-base
  training step at batch 32) and [614, 768], p = 0 and p = 0.1, from the
  forward kernel's r, statistics and Seed, against the autograd of
  ``F.layer_norm(x + y)`` (and with ``F.dropout(y)``), with the bytes
  bound (read r and dz, write dx, and dy at p > 0);
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
    drop_f = torch.nn.functional.dropout
    for n in (128, 1024, 4096):
        x, y = t(n, C), t(n, C)
        for p in (0.0, 0.1):
            words = smoke.WORDS if p else None
            err = max(float((u - w).abs().max()) for u, w in zip(
                fl.fused_ln_fwd(x, y, g, b, p, words, 1e-5),
                fl.fused_ln_reference(x, y, g, b, 1e-5, p, words)))
            row = {"kernel": "fused_ln", "rows": n, "cols": C, "p": p,
                   "ms": smoke.time_cold(
                       lambda: fl.fused_ln_fwd(x, y, g, b, p, words, 1e-5),
                       flush),
                   "library_ms": smoke.time_cold(
                       lambda: ln_f(x + (drop_f(y, p) if p else y), (C,), g,
                                    b, 1e-5), flush),
                   "bound_ms": smoke.bound(4 * (4 * n * C + 2 * C + 2 * n),
                                           9 * n * C)[0],
                   "max_abs_err": err}
            print("fused_ln [%d, %d] p=%g: kernel %.6f ms, F.layer_norm(x + "
                  "y%s) %.6f, bound %.6f (bytes), err vs plain %.3g" % (
                      n, C, p, row["ms"], ", dropped" if p else "",
                      row["library_ms"], row["bound_ms"], err), flush=True)
            rows.append(row)
    rows.append(dropout_row(smoke, t, flush))
    rows += bwd_rows(smoke, fl, t, g, b, flush)
    print(json.dumps({"ln_bench": rows}), flush=True)


def dropout_row(smoke, t, flush):
    """The dropout op's kernel at the attention probabilities' shape,
    p = 0.1, against F.dropout (bytes: read x, write out and the mask
    bytes)."""
    from paddle_tpu_torch.kernels import dropout as dk
    from paddle_tpu_torch.ops.common import byte_threshold, realized_keep_prob

    x = t(32, 12, 128, 128)
    thr, q = byte_threshold(0.9), realized_keep_prob(0.9)
    row = {"kernel": "dropout", "shape": list(x.shape), "p": 0.1,
           "ms": smoke.time_cold(
               lambda: dk.dropout(x, smoke.WORDS, thr, q, True), flush),
           "library_ms": smoke.time_cold(
               lambda: torch.nn.functional.dropout(x, 0.1), flush),
           "bound_ms": smoke.bound(9 * x.numel(), x.numel())[0]}
    print("dropout [32, 12, 128, 128] p=0.1: kernel %.6f ms, F.dropout "
          "%.6f, bound %.6f (bytes)" % (row["ms"], row["library_ms"],
                                        row["bound_ms"]), flush=True)
    return row


def bwd_rows(smoke, fl, t, g, b, flush):
    ln_f = torch.nn.functional.layer_norm
    drop_f = torch.nn.functional.dropout
    seed_t = torch.empty(2, dtype=torch.int32, device=g.device)
    rows = []
    for n in (4096, 614):
        x, y, dz = t(n, C), t(n, C), t(n, C)
        leaves = [a.detach().requires_grad_() for a in (x, y, g, b)]
        for p in (0.0, 0.1):
            words = smoke.WORDS if p else None
            _z, r, mean, var = fl.fused_ln_fwd(x, y, g, b, p, words, 1e-5,
                                               seed_out=seed_t)
            args = (r, g, mean, var, dz, p, seed_t if p else None)
            got = fl.fused_ln_bwd(*args)
            want = fl.fused_ln_bwd_reference(r, g, mean, var, dz, 1e-5, p,
                                             words)
            err = max(float((u - w).abs().max())
                      for u, w in zip(got[:2], want[:2]))
            z = ln_f(leaves[0] + (drop_f(leaves[1], p) if p else leaves[1]),
                     (C,), leaves[2], leaves[3], 1e-5)
            nbytes = 4 * ((4 if p else 3) * n * C + 2 * n + 3 * C) + \
                (8 if p else 0)
            row = {"kernel": "fused_ln_bwd", "rows": n, "cols": C, "p": p,
                   "ms": smoke.time_cold(lambda: fl.fused_ln_bwd(*args),
                                         flush),
                   "library_ms": smoke.time_cold(
                       lambda: torch.autograd.grad(z, leaves, dz,
                                                   retain_graph=True),
                       flush),
                   "bound_ms": smoke.bound(nbytes,
                                           (12 if p else 11) * n * C)[0],
                   "max_abs_err": err}
            print("fused_ln_bwd [%d, %d] p=%g: kernel %.6f ms, autograd of "
                  "F.layer_norm(x + y%s) %.6f, bound %.6f (bytes), err vs "
                  "plain %.3g" % (n, C, p, row["ms"],
                                  ", dropped" if p else "",
                                  row["library_ms"], row["bound_ms"], err),
                  flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
