#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time on the card.

    python3 tools/torch_decode_profile.py [--steps 50] [--lanes 8]

Runs the port's decode step (``Decoder.paged_step`` over a
``PagedKVCache``, as ``DecodeEngine`` runs it: int32 step inputs copied
from the host, next tokens copied back) at GPT-2-small width with seeded
random weights, in steady decode with lane contexts staggered 16 apart
from about 160 positions.  Times ``--steps`` steps on the host clock, then records as
many with torch.profiler and prints the device busy time per step, the
device's idle share, and device time by kernel group (the paged-attention
kernel, matrix products, everything else).  Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _group(name):
    n = name.lower()
    if "paged_attention" in n:
        return "paged_attention kernel"
    if "gemm" in n or "gemv" in n or "xmma" in n or "cutlass" in n:
        return "matrix products (cuBLAS)"
    return "other kernels (elementwise, norm, index, copies)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lanes", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profiles the port on the card")
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.serving import (Decoder, DecoderConfig,
                                          KVCacheConfig, PagedKVCache,
                                          init_decoder_params)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s" % card, flush=True)
    set_f32_numerics()
    dev = torch.device("cuda")
    cfg = DecoderConfig(vocab=50257, layers=12, heads=12, head_dim=64,
                        ffn=3072, max_seq=1024)
    dec = Decoder(cfg, init_decoder_params(cfg, seed=0), device=dev)
    bs, maxb, lanes = 16, cfg.max_seq // 16, args.lanes
    cache = PagedKVCache(KVCacheConfig(cfg.layers, cfg.heads, cfg.head_dim,
                                       bs, 1 + lanes * maxb), device=dev)
    rng = np.random.RandomState(0)
    tables = (1 + np.arange(lanes * maxb, dtype=np.int32)
              ).reshape(lanes, maxb)
    pos = (100 + 16 * np.arange(lanes)).astype(np.int32)
    tok = rng.randint(0, cfg.vocab, lanes).astype(np.int32)

    def step():
        nxt, _ = dec.paged_step(
            cache.k, cache.v, torch.from_numpy(tok).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos + 1).to(dev))
        tok[:] = nxt.cpu().numpy()
        pos[:] += 1

    for _ in range(10):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    first = pos + 1                   # contexts of the profiled window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device activity")
    n = args.steps
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = max(e.time_range.end for e in kernels) \
        - min(e.time_range.start for e in kernels)
    print("window: %d decode steps at %d lanes, contexts %d..%d: host "
          "%.3f ms/step unprofiled; device busy %.3f ms/step; device idle "
          "share %.3f over the kernels' span"
          % (n, lanes, first.min(), first.max() + n - 1, host_ms,
             busy_us / 1e3 / n, 1.0 - busy_us / span_us), flush=True)
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        c = names.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += us
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("group %-50s %8.4f ms/step %5.1f%% of busy"
              % (g, us / 1e3 / n, 100.0 * us / busy_us))
    print("kernels per step: %.1f; top by device time (launches/step, "
          "ms/step):" % (len(kernels) / n))
    for name, (cnt, us) in sorted(names.items(),
                                  key=lambda kv: -kv[1][1])[:12]:
        print("  %5.1f %8.4f  %s" % (cnt / n, us / 1e3 / n, name[:100]))


if __name__ == "__main__":
    main()
