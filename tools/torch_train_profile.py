#!/usr/bin/env python3
"""Where a BERT-base pretraining step of the PyTorch port spends its time
on the card.

    python3 tools/torch_train_profile.py [--steps 5] [--batch 32]
        [--emission dropout0|composed|small]

Builds BERT-base pretraining (seq 128, Adam at lr 1e-4, seeded random
weights) with the port's ``build_pretrain`` in one of three emissions:
``dropout0`` (dropout 0, one flash_attention op a layer; the default),
``composed`` (BERT's dropout 0.1: the embeddings dropout and, a layer,
matmul, bias add, softmax, dropout, matmul) or ``small`` (dropout 0.1
with ``BERT_FUSED_ATTN=1`` and ``FLAGS_fused_small_attention``: one
flash_attention op a layer on the small-sequence kernels), and runs its
main program through the port's Executor on the card, step after step
on one fixed batch, as a training loop does: numpy feeds copied in, the
loss copied back.  After warm-up steps it times ``--steps`` steps on the
host clock, then records as many with torch.profiler and prints the
device busy time per step, the device's idle share over the kernels'
span, kernels per step, and the step's device time split into matrix
products, the ported kernels (flash forward, the fused flash backward,
small-sequence attention forward and backward, dropout, fused LN
forward and backward, LayerNorm, fused Adam) and the rest.  Last, as
many steps
again with each op's host time recorded (the executor's ``run_op``
wrapped by a clock; launches are asynchronous, so this is the time the
host spends issuing each op), summed by op type.  Needs one CUDA card.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 128

# kernel name fragments of the ported kernels (csrc/*.cu)
# (first match wins: the small backward is the fused backward's core
# instantiated with the mask, flash_bwd_kernel<.., .., true>)
_PORTED = (("flash_fwd", "flash attention forward"),
           ("true>(flash_bwd::args)",
            "small attention backward (fused dQ, dK, dV, the mask)"),
           ("flash_bwd", "flash attention backward (fused dQ, dK, dV)"),
           ("small_fwd", "small attention forward"),
           ("dropout_kernel", "dropout"),
           ("fused_ln_bwd", "fused LN backward"),
           ("reduce_partials", "fused LN backward"),
           ("ln_rows", "fused LN forward + LayerNorm"),
           ("fused_adam", "fused Adam"))


def _group(name):
    n = name.lower()
    for frag, group in _PORTED:
        if frag in n:
            return "ported: " + group
    if "gemm" in n or "gemv" in n or "xmma" in n or "cutlass" in n \
            or "splitk" in n:
        return "matrix products (cuBLAS)"
    return "other kernels (elementwise, reductions, embedding, copies)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--emission", choices=("dropout0", "composed", "small"),
                    default="dropout0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profiles the port on the card")
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import framework, set_flags
    from paddle_tpu_torch.core import Executor, Scope
    from paddle_tpu_torch.models.bert import (BertConfig, build_pretrain,
                                              pretrain_feed)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s" % card, flush=True)
    cfg = BertConfig(dropout=0.0 if args.emission == "dropout0" else 0.1)
    if args.emission == "small":
        os.environ["BERT_FUSED_ATTN"] = "1"   # read at build time
        set_flags({"FLAGS_fused_small_attention": True})
    main_prog, startup = framework.Program(), framework.Program()
    startup.random_seed = 11
    with framework.program_guard(main_prog, startup):
        _inputs, loss = build_pretrain(cfg, SEQ, lr=1e-4)
    exe = Executor()                   # the card; TF32 off
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = pretrain_feed(np.random.RandomState(3), cfg, args.batch, SEQ)

    def step():
        return exe.run(main_prog, feed=feed, fetch_list=[loss],
                       scope=scope)[0]

    for _ in range(args.warmup):       # fuses the optimizer ops, plans
        step()
    torch.cuda.synchronize()
    n = args.steps
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()                          # the loss copy-back synchronizes
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = max(e.time_range.end for e in kernels) \
        - min(e.time_range.start for e in kernels)
    ops = len(main_prog.global_block().ops)
    print("BERT-base pretraining, emission %s (dropout %g), batch %d, seq "
          "%d: %d ops a step; %d "
          "steps: host %.3f ms/step unprofiled (p50 %.3f); device busy "
          "%.3f ms/step; device idle share %.3f over the kernels' span; "
          "peak device memory %.2f GB"
          % (args.emission, cfg.dropout, args.batch, SEQ, ops, n,
             float(np.mean(host)),
             float(np.percentile(host, 50)), busy_us / 1e3 / n,
             1.0 - busy_us / span_us, peak_gb), flush=True)
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        c = names.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += us
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  group %-58s %9.4f ms/step %5.1f%% of busy"
              % (g, us / 1e3 / n, 100.0 * us / busy_us))
    print("  kernels per step: %.1f; top by device time "
          "(launches/step, ms/step):" % (len(kernels) / n))
    for name, (cnt, us) in sorted(names.items(),
                                  key=lambda kv: -kv[1][1])[:16]:
        print("    %6.1f %9.4f  %s" % (cnt / n, us / 1e3 / n, name[:100]))

    from paddle_tpu_torch.core import executor as executor_mod

    run_op = executor_mod.run_op
    host_by_type = collections.defaultdict(lambda: [0, 0.0])

    def clocked(op, *a, **k):
        t0 = time.perf_counter()
        run_op(op, *a, **k)
        c = host_by_type[op.type]
        c[0] += 1
        c[1] += time.perf_counter() - t0

    executor_mod.run_op = clocked
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall = (time.perf_counter() - t0) * 1e3 / n
    executor_mod.run_op = run_op
    in_ops = sum(c[1] for c in host_by_type.values()) * 1e3 / n
    print("  host: %.3f ms/step, %.3f of it issuing ops; by op type "
          "(ops/step, host ms/step):" % (wall, in_ops))
    for t, (cnt, sec) in sorted(host_by_type.items(),
                                key=lambda kv: -kv[1][1])[:14]:
        print("    %6.1f %9.4f  %s" % (cnt / n, sec * 1e3 / n, t))


if __name__ == "__main__":
    main()
