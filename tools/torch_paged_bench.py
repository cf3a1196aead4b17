#!/usr/bin/env python3
"""The paged decode-attention kernel (row 1) on the card.

    python3 tools/torch_paged_bench.py [--root DIR]

Times ``paged_attention`` with CUDA events, L2 flushed before each call
(``chip_smoke.time_cold``), at GPT-2 small's heads (H = 12, D = 64) over
a table of MAXB = 64 blocks of 16 positions (its 1024-token context),
eight lanes, shuffled block ids:

* the smoke's timed shape, lens {1, 15, 16, 17, 300, 511, 1023, 1024};
* uniform lens of 64, 256 and 1024;
* the decode phase's shape, eight lanes of 40-70 tokens;
* the decode profile's window, lens 101 ... 213 staggered by 16;
* lens at a chunk boundary of the split kernel (255, 256, 257) and one
  block of 16;
* D = 128 (B = 4, H = 8, MAXB = 32, lens 1, 77, 256, 512);

each against SDPA over K/V gathered beforehand into contiguous
[B, H, S, D] with the length mask (the gather not timed), with the bytes
bound at 3.35 TB/s, the error against the plain version, and whether
two calls give the same bits.  A cold-L2 timing of a one-element add
gives the floor of the method.

``--root DIR`` times the kernels of the checkout at DIR (for example a
parent commit unpacked under build/), so that two trees can be timed in
turns in one call to the card.  Ends with one JSON line of the readings.
Needs one CUDA card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED_LENS = (1, 15, 16, 17, 300, 511, 1023, 1024)


def shapes(rng):
    """(name, B, H, D, bs, MAXB, lens) of each timed case."""
    g = (8, 12, 64, 16, 64)
    return [
        ("timed",) + g + (rng.permutation(TIMED_LENS),),
        ("uniform 64",) + g + ([64] * 8,),
        ("uniform 256",) + g + ([256] * 8,),
        ("uniform 1024",) + g + ([1024] * 8,),
        ("decode 40-70",) + g + (rng.randint(40, 71, 8),),
        ("profile window",) + g + (101 + 16 * np.arange(8),),
        ("chunk boundary",) + g + ([255, 256, 257, 255, 256, 257, 1, 0],),
        ("one block",) + (8, 12, 64, 16, 1) + ([16, 1, 9, 16, 0, 3, 16, 2],),
        ("D=128", 4, 8, 128, 16, 32, [1, 77, 256, 512]),
    ]


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
    from paddle_tpu_torch.kernels import paged_attention as pa

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    print("kernels of %s" % os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(pa.__file__)))), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    tiny = torch.zeros(1, device=dev)
    floor_ms = smoke.time_cold(lambda: tiny.add_(1.0), flush)
    print("floor (a one-element add, timed as the kernels are) %.6f ms"
          % floor_ms, flush=True)
    rows = [{"case": "floor", "ms": floor_ms}]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.RandomState(0)
    for name, bb, h, d, bs, maxb, lens in shapes(rng):
        c = smoke.paged_case(rng, bb, h, d, bs, maxb, lens, dev)
        a = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        out = pa.paged_attention(*a)
        again = pa.paged_attention(*a)
        live = c["lens"] > 0
        err = float((out[live] - pa.paged_attention_reference(*a)[live])
                    .abs().max())
        lens = np.asarray(lens, np.int64)
        s = max(1, int(lens.max()))
        idx = c["tables"].long().clamp(min=0)
        kg, vg = (t[idx].reshape(bb, -1, h, d)[:, :s].permute(0, 2, 1, 3)
                  .contiguous() for t in (c["k"], c["v"]))
        mask = (torch.arange(s, device=dev)[None, :]
                < c["lens"][:, None].long())[:, None, None, :]
        qg = c["q"][:, :, None, :]
        tok = int(lens.sum())
        nbytes = (2 * tok * h * d * 4 + 2 * bb * h * d * 4 + 4 * bb
                  + 4 * int(sum(-(-n // bs) for n in lens)))
        row = {"case": name, "B": bb, "H": h, "D": d, "bs": bs,
               "MAXB": maxb, "lens": [int(n) for n in lens],
               "ms": smoke.time_cold(lambda: pa.paged_attention(*a), flush),
               "library_ms": smoke.time_cold(
                   lambda: sdpa(qg, kg, vg, attn_mask=mask), flush),
               "bound_ms": smoke.bound(nbytes, tok * h * (4 * d + 5))[0],
               "max_abs_err": err,
               "bitwise_repeat": bool(torch.equal(out, again))}
        print("paged_attention %-15s B=%d H=%d D=%d bs=%d MAXB=%d: kernel "
              "%.6f ms, SDPA %.6f, bound %.6f (bytes), err vs plain %.3g, "
              "repeat %s" % (name, bb, h, d, bs, maxb, row["ms"],
                             row["library_ms"], row["bound_ms"], err,
                             "bitwise" if row["bitwise_repeat"]
                             else "DIFFERS"), flush=True)
        rows.append(row)
    print(json.dumps({"paged_bench": rows}), flush=True)


if __name__ == "__main__":
    main()
