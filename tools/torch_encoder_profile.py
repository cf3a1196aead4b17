#!/usr/bin/env python3
"""Where a BERT-base encoder batch of the PyTorch port spends its time on
the card.

    python3 tools/torch_encoder_profile.py [--batches 20] [--buckets 8,32]

Builds BERT-base (seq 128, seeded random weights) with the port's Program
front end and runs its inference program through the port's Executor on
the card, one batch after another on one thread, as ServingEngine runs a
padded bucket: numpy feeds copied in, the sequence output copied back.
For each bucket size it times ``--batches`` batches on the host clock,
then records as many with torch.profiler and prints the device busy time
per batch, the device's idle share, and device time by kernel group (the
three ported kernels, matrix products, everything else).  Needs one CUDA
card.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 128


def _group(name):
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention kernel"
    if "layer_norm_vec" in n:
        return "layer_norm kernel"
    if "ln_rows" in n:
        return "fused_ln kernel"
    if "gemm" in n or "gemv" in n or "xmma" in n or "cutlass" in n:
        return "matrix products (cuBLAS)"
    return "other kernels (elementwise, embedding, copies)"


def _feeds(rng, rows, cfg):
    lens = rng.randint(16, SEQ + 1, rows)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.float32)
    return {"src_ids": rng.randint(0, cfg.vocab_size, (rows, SEQ, 1))
            .astype(np.int64),
            "pos_ids": np.tile(np.arange(SEQ).reshape(1, SEQ, 1),
                               (rows, 1, 1)).astype(np.int64),
            "sent_ids": np.zeros((rows, SEQ, 1), np.int64),
            "input_mask": mask[:, :, None]}


def profile_bucket(exe, main, fetch, scope, feed, n):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def batch():
        exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)

    for _ in range(3):
        batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        batch()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            batch()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = max(e.time_range.end for e in kernels) \
        - min(e.time_range.start for e in kernels)
    return host_ms, kernels, busy_us, span_us


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--buckets", default="8,32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profiles the port on the card")
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor, Scope
    from paddle_tpu_torch.models.bert import BERT_BASE, bert_encoder

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s" % card, flush=True)
    cfg = BERT_BASE
    main_prog, startup = framework.Program(), framework.Program()
    startup.random_seed = 7
    with framework.program_guard(main_prog, startup):
        _inputs, seq_out = bert_encoder(cfg, SEQ, is_test=True)
    main_prog = main_prog.clone(for_test=True)
    exe = Executor()                   # the card; TF32 off
    scope = Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    n = args.batches
    for bucket in (int(b) for b in args.buckets.split(",")):
        feed = _feeds(rng, bucket, cfg)
        host_ms, kernels, busy_us, span_us = profile_bucket(
            exe, main_prog, seq_out, scope, feed, n)
        print("bucket %d (%d tokens): %d batches: host %.3f ms/batch "
              "unprofiled; device busy %.3f ms/batch; device idle share "
              "%.3f over the kernels' span"
              % (bucket, bucket * SEQ, n, host_ms, busy_us / 1e3 / n,
                 1.0 - busy_us / span_us), flush=True)
        groups, names = {}, {}
        for e in kernels:
            us = e.time_range.elapsed_us()
            g = _group(e.name)
            groups[g] = groups.get(g, 0.0) + us
            c = names.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += us
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
            print("  group %-48s %8.4f ms/batch %5.1f%% of busy"
                  % (g, us / 1e3 / n, 100.0 * us / busy_us))
        print("  kernels per batch: %.1f; top by device time "
              "(launches/batch, ms/batch):" % (len(kernels) / n))
        for name, (cnt, us) in sorted(names.items(),
                                      key=lambda kv: -kv[1][1])[:12]:
            print("    %6.1f %8.4f  %s" % (cnt / n, us / 1e3 / n,
                                           name[:100]))


if __name__ == "__main__":
    main()
