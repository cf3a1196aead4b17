#!/usr/bin/env python3
"""Where the flash-attention kernels' time goes on the card.

    python3 tools/torch_flash_bwd_bench.py [--mode fwd,bwd,small,small_fwd]
                                           [--sweep] [--root DIR]

At BERT-base's heads (H = 12, D = 64), strided q/k/v/dO as the main path
hands them over and a padding bias [B, 1, S, S], it times with CUDA
events, L2 flushed before each call (``chip_smoke.time_cold``):

* ``fwd`` (row 2): ``flash_attention`` at S = 128 and B = 1, 8, 32 (the
  encoder's buckets and the training batch), against SDPA with the same
  mask, with the rate on its 4 flops per (i, j, d) and its bound (bytes
  at 3.35 TB/s; the 3xTF32 products at 495 TF/s); ``--sweep`` also times
  each CTA shape of ``FWD_WARPS``;
* ``bwd`` (rows 3, 4): the wrapper ``flash_attention_bwd_fused`` (the dQ
  zero fill and the kernel) at 4096 query rows a call (B x S = 32 x 128,
  16 x 256, 8 x 512, 4 x 1024), the zero fill alone, and SDPA's whole
  backward (its forward graph built once and not timed).  A longer
  sequence gives a CTA more query tiles to stream past its resident K and
  V, so the rate's growth with S shows what the CTA's set-up costs at S =
  128;
* ``small`` (row 6): ``small_attention_bwd`` (the op's call: delta =
  rowsum(dO . O), dQ's zero fill, the kernel) at B = 32, S = 128 and B =
  16, S = 256, dropout p = 0.1 with the smoke's seed words and p = 0,
  against SDPA's backward with dropout p (its forward graph built once),
  with delta, the zero fill and ``small_attention_bwd_fused`` (the zero
  fill and the kernel) each timed alone;

each with the rate on 10 flops per (i, j, d) of the backward and the
operations bound at 67 TF/s;

* ``small_fwd`` (row 5): ``small_attention_fwd`` (the kernel writes the
  seed words too) at B = 32, S = 128 and B = 16, S = 256, dropout p = 0.1
  and p = 0, against SDPA with ``dropout_p`` p and the same mask, with
  the rate on 4 flops per (i, j, d), the bound of the 3xTF32 design
  (bytes at 3.35 TB/s; the TF32 products at 495 TF/s) and the f32 SIMT
  bound beside it, and the kernel's CTAs an SM.

``--root DIR`` times the kernels of the
checkout at DIR (for example a parent commit unpacked under build/), so
that two trees can be timed in turns in one call to the card.  Ends with
one JSON line of the readings.  Needs one CUDA card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, D, ROWS = 12, 64, 4096


def inputs(rng, dev, bb, s, n):
    """n strided [B, H, S, D] operands and a padding bias [B, 1, S, S]."""
    ops = [torch.from_numpy(rng.randn(bb, s, H * D).astype(np.float32))
           .to(dev).view(bb, s, H, D).permute(0, 2, 1, 3) for _ in range(n)]
    keep = (rng.rand(bb, 1, 1, s) > 0.25).astype(np.float32)
    keep[..., 0] = 1.0
    bias = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        (1.0 - keep) * -1e4, (bb, 1, s, s)))).to(dev)
    return ops, bias


def fwd_mode(smoke, fa, dev, flush, rng, sweep):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the floor of a cold-L2 timing on this card: one tiny kernel
    tiny = torch.zeros(1, device=dev)
    floor_ms = smoke.time_cold(lambda: tiny.add_(1.0), flush)
    print("fwd: floor (a one-element add, timed as the kernels are) %.6f ms"
          % floor_ms, flush=True)
    rows = [{"mode": "floor", "ms": floor_ms}]
    s = 128
    for bb in (1, 8, 32):
        (q, k, v), bias = inputs(rng, dev, bb, s, 3)
        flops = 4 * bb * H * s * s * D
        nbytes = 4 * (4 * bb * H * s * D + bb * s * s + bb * H * s)
        bound_ms, by = smoke.bound(nbytes, 0, 3 * flops)
        row = {"mode": "fwd", "B": bb, "S": s,
               "kernel_ms": smoke.time_cold(
                   lambda: fa.flash_attention(q, k, v, bias), flush),
               "sdpa_ms": smoke.time_cold(
                   lambda: sdpa(q, k, v, attn_mask=bias), flush),
               "bound_ms": bound_ms, "bound_by": by,
               "f32_simt_bound_ms": smoke.bound(nbytes, flops)[0]}
        if hasattr(fa, "FWD_DEFAULT_WARPS"):
            row["warps"] = fa.FWD_DEFAULT_WARPS
        if sweep:
            for w in fa.FWD_WARPS:
                row["warps_%d_ms" % w] = smoke.time_cold(
                    lambda: fa.flash_attention(q, k, v, bias, warps=w), flush)
                row["warps_%d_ctas_per_sm" % w] = \
                    fa.flash_attention_fwd_ctas_per_sm(D, w)
        row["kernel_tflops"] = flops / row["kernel_ms"] / 1e9
        print("fwd B=%d S=%d: kernel %.6f ms (%.1f TF/s%s), SDPA %.6f, "
              "bound %.6f (%s; f32 SIMT %.6f)%s" % (
                  bb, s, row["kernel_ms"], row["kernel_tflops"],
                  ", %d warps" % row["warps"] if "warps" in row else "",
                  row["sdpa_ms"], bound_ms, by, row["f32_simt_bound_ms"],
                  "".join("; %d warps %.6f ms (%d CTAs an SM)" % (
                      w, row["warps_%d_ms" % w],
                      row["warps_%d_ctas_per_sm" % w])
                      for w in fa.FWD_WARPS) if sweep else ""), flush=True)
        rows.append(row)
    return rows


def bwd_mode(smoke, fa, dev, flush, rng):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for s in (128, 256, 512, 1024):
        bb = ROWS // s
        (q, k, v, do), bias = inputs(rng, dev, bb, s, 4)
        out, lse = fa.flash_attention(q, k, v, bias)
        delta = fa.attention_delta(out, do)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = sdpa(*leaves, attn_mask=bias)
        fused_ms = smoke.time_cold(
            lambda: fa.flash_attention_bwd_fused(q, k, v, bias, do, lse,
                                                 delta), flush)
        zero_ms = smoke.time_cold(
            lambda: torch.zeros(q.shape, dtype=q.dtype, device=dev), flush)
        sdpa_ms = smoke.time_cold(
            lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
            flush)
        flops = 10 * bb * H * s * s * D
        row = {"mode": "bwd", "B": bb, "S": s, "fused_ms": fused_ms,
               "zero_fill_ms": zero_ms, "sdpa_bwd_ms": sdpa_ms,
               "bound_ms": flops / 67e12 * 1e3,
               "fused_tflops": flops / fused_ms / 1e9}
        print("bwd B=%d S=%d: fused %.6f ms (%.1f TF/s; dQ zero fill %.6f), "
              "SDPA backward %.6f, bound %.6f" % (
                  bb, s, fused_ms, row["fused_tflops"], zero_ms, sdpa_ms,
                  row["bound_ms"]), flush=True)
        rows.append(row)
    return rows


def small_mode(smoke, fa, dev, flush, rng):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    scale = D ** -0.5
    for bb, s in ((32, 128), (16, 256)):
        (q, k, v, do), bias = inputs(rng, dev, bb, s, 4)
        for p in (0.1, 0.0):
            seed_t = torch.empty(2, dtype=torch.int32, device=dev)
            out, lse = fa.small_attention_fwd(q, k, v, bias, scale, p,
                                              smoke.WORDS, seed_out=seed_t)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = sdpa(*leaves, attn_mask=bias, dropout_p=p)
            ms = smoke.time_cold(
                lambda: fa.small_attention_bwd(q, k, v, bias, scale, p,
                                               seed_t, out, lse, do), flush)
            sdpa_ms = smoke.time_cold(
                lambda: torch.autograd.grad(o, leaves, do,
                                            retain_graph=True), flush)
            # the wrapper's work around the kernel: delta = rowsum(dO . O)
            # (the reference's expression), and dQ's zero fill
            delta_ms = smoke.time_cold(lambda: fa.attention_delta(out, do),
                                       flush)
            delta = fa.attention_delta(out, do)
            fused_ms = smoke.time_cold(
                lambda: fa.small_attention_bwd_fused(
                    q, k, v, bias, scale, p, seed_t, do, lse, delta),
                flush) if hasattr(fa, "small_attention_bwd_fused") else None
            zero_ms = smoke.time_cold(
                lambda: torch.zeros(q.shape, dtype=q.dtype, device=dev),
                flush)
            flops = 10 * bb * H * s * s * D
            row = {"mode": "small", "B": bb, "S": s, "p": p,
                   "kernel_ms": ms, "fused_ms": fused_ms,
                   "sdpa_bwd_ms": sdpa_ms,
                   "delta_ms": delta_ms, "zero_fill_ms": zero_ms,
                   "bound_ms": flops / 67e12 * 1e3,
                   "kernel_tflops": flops / ms / 1e9}
            if hasattr(fa, "small_attention_bwd_ctas_per_sm"):
                row["ctas_per_sm"] = fa.small_attention_bwd_ctas_per_sm(D)
            print("small B=%d S=%d p=%g: wrapper %.6f ms (%.1f TF/s; delta "
                  "%.6f, dQ zero fill %.6f when timed alone%s), SDPA "
                  "backward with dropout %.6f, bound %.6f" % (
                      bb, s, p, ms, row["kernel_tflops"], delta_ms, zero_ms,
                      "" if fused_ms is None else
                      "; the kernel with its zero fill %.6f" % fused_ms,
                      sdpa_ms, row["bound_ms"]), flush=True)
            rows.append(row)
    return rows


def small_fwd_mode(smoke, fa, dev, flush, rng):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    scale = D ** -0.5
    for bb, s in ((32, 128), (16, 256)):
        (q, k, v), bias = inputs(rng, dev, bb, s, 3)
        seed_t = torch.empty(2, dtype=torch.int32, device=dev)
        flops = 4 * bb * H * s * s * D
        # read q, k, v, the bias; write out, lse and the seed words; ~6
        # SIMT operations a score (scale, bias, max, exp, sum, the mask)
        nbytes = 4 * (4 * bb * H * s * D + bb * s * s + bb * H * s) + 8
        bound_ms, by = smoke.bound(nbytes, 6 * bb * H * s * s, 3 * flops)
        for p in (0.1, 0.0):
            ms = smoke.time_cold(
                lambda: fa.small_attention_fwd(q, k, v, bias, scale, p,
                                               smoke.WORDS, seed_out=seed_t),
                flush)
            sdpa_ms = smoke.time_cold(
                lambda: sdpa(q, k, v, attn_mask=bias, dropout_p=p), flush)
            row = {"mode": "small_fwd", "B": bb, "S": s, "p": p,
                   "kernel_ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms,
                   "bound_by": by,
                   "f32_simt_bound_ms": smoke.bound(nbytes, flops)[0],
                   "kernel_tflops": flops / ms / 1e9}
            if hasattr(fa, "small_attention_fwd_ctas_per_sm"):
                row["ctas_per_sm"] = fa.small_attention_fwd_ctas_per_sm(D)
            print("small_fwd B=%d S=%d p=%g: kernel %.6f ms (%.1f TF/s%s), "
                  "SDPA with dropout %.6f, bound %.6f (%s; f32 SIMT %.6f)"
                  % (bb, s, p, ms, row["kernel_tflops"],
                     ", %d CTAs an SM" % row["ctas_per_sm"]
                     if "ctas_per_sm" in row else "", sdpa_ms, bound_ms, by,
                     row["f32_simt_bound_ms"]), flush=True)
            rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fwd,bwd,small,small_fwd",
                    help="comma-separated: fwd, bwd, small, small_fwd")
    ap.add_argument("--sweep", action="store_true",
                    help="fwd: also time each CTA shape")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose kernels are timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the kernels on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import flash_attention as fa

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    print("kernels of %s" % os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(fa.__file__)))), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)
    rows = []
    for mode in args.mode.split(","):
        if mode == "fwd":
            rows += fwd_mode(smoke, fa, dev, flush, rng, args.sweep)
        elif mode == "bwd":
            rows += bwd_mode(smoke, fa, dev, flush, rng)
        elif mode == "small":
            rows += small_mode(smoke, fa, dev, flush, rng)
        elif mode == "small_fwd":
            rows += small_fwd_mode(smoke, fa, dev, flush, rng)
        else:
            sys.exit("unknown mode %r" % mode)
    print(json.dumps({"flash_bwd_bench": rows}), flush=True)


if __name__ == "__main__":
    main()
