#!/usr/bin/env python3
"""Where the fused flash-attention backward's time goes on the card.

    python3 tools/torch_flash_bwd_bench.py

At BERT-base's heads (H = 12, D = 64), 4096 query rows a call (B x S =
32 x 128, 16 x 256, 8 x 512, 4 x 1024), strided q/k/v/dO as the main
path hands them over and a padding bias [B, 1, S, S], it times with
CUDA events, L2 flushed before each call (``chip_smoke.time_cold``):

* the wrapper ``flash_attention_bwd_fused`` (the dQ zero fill and the
  kernel);
* the zero fill of dQ alone (``torch.zeros`` of its shape);
* SDPA's whole backward on the same inputs (its forward graph built once
  and not timed);

and prints each with the rate on the kernel's 10 flops per (i, j, d)
and the operations bound at 67 TF/s.  A longer sequence gives a CTA
more query tiles to stream past its resident K and V, so the rate's
growth with S shows what the CTA's set-up (loading K, V and the first
query tile, the waves' tails) costs at S = 128.  Ends with one JSON
line of the readings.  Needs one CUDA card.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, D, ROWS = 12, 64, 4096


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the kernel on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import flash_attention as fa

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for s in (128, 256, 512, 1024):
        bb = ROWS // s
        q, k, v, do = (torch.from_numpy(rng.randn(bb, s, H * D)
                                        .astype(np.float32)).to(dev)
                       .view(bb, s, H, D).permute(0, 2, 1, 3)
                       for _ in range(4))
        keep = (rng.rand(bb, 1, 1, s) > 0.25).astype(np.float32)
        keep[..., 0] = 1.0
        bias = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            (1.0 - keep) * -1e4, (bb, 1, s, s)))).to(dev)
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
        row = {"B": bb, "S": s, "fused_ms": fused_ms, "zero_fill_ms": zero_ms,
               "sdpa_bwd_ms": sdpa_ms, "bound_ms": flops / 67e12 * 1e3,
               "fused_tflops": flops / fused_ms / 1e9}
        print("B=%d S=%d: fused %.6f ms (%.1f TF/s; dQ zero fill %.6f), "
              "SDPA backward %.6f, bound %.6f" % (
                  bb, s, fused_ms, row["fused_tflops"], zero_ms, sdpa_ms,
                  row["bound_ms"]), flush=True)
        rows.append(row)
    print(json.dumps({"flash_bwd_bench": rows}), flush=True)


if __name__ == "__main__":
    main()
