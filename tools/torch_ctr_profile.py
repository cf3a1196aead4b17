#!/usr/bin/env python3
"""Where a DLRM training step of the PyTorch port spends its time on the
host and on the card.

    python3 tools/torch_ctr_profile.py [--steps 5] [--batch 2048]

Builds DLRM as chip_smoke.py does (``dlrm_program``: the Criteo
Terabyte configuration, 26 tables of width 128 in two host-resident
shards each, MLPerf's multi-hot bag sizes, seeded random weights and
ids) and trains it SGD step after step on one batch under
``FLAGS_use_pallas_embedding_bag`` (the embedding-bag kernel, row 15).
After two warm-up steps (the first draws the touched rows and plans) it
times ``--steps`` steps on the host clock, split into:

* pull: ``prepare_feed_bags`` of the 26 tables (``np.unique``, the
  shards' lookups, the padded row buffers);
* feed: the executor's copies of the feeds to the card (pageable);
* run: the rest of ``Executor.run``, issuing the program's ops;
* fetch: the loss and the 26 row gradients copied back (this waits for
  the step's device work to end);
* push: ``push_grads`` of the 26 tables (the shards' SGD updates).

Then it records as many steps with torch.profiler and prints the device
busy time a step, the device's idle share over the kernels' span, peak
device memory, the device time by group (cuBLAS products, the
embedding-bag kernel, the row-gradient scatter-add, copies, the rest),
and the host time by op type.  Needs one CUDA card.
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

_GROUPS = (("bag_kernel", "ported: row 15 embedding bag"),
           ("indexfunc", "row gradients (index_add_ scatter)"),
           ("memcpy", "copies (feeds in, fetches out)"),
           ("memset", "copies (feeds in, fetches out)"),
           ("gemm", "cuBLAS products"), ("gemv", "cuBLAS products"),
           ("cutlass", "cuBLAS products"), ("sm90_xmma", "cuBLAS products"))


def _group(name):
    n = name.lower()
    for frag, group in _GROUPS:
        if frag in n:
            return group
    return "other kernels (elementwise, reductions, gathers)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profiles the port on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch import set_f32_numerics, set_flags
    from paddle_tpu_torch.core import Executor, Scope
    from paddle_tpu_torch.core import executor as executor_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s" % card, flush=True)
    set_f32_numerics()
    set_flags({"FLAGS_use_pallas_embedding_bag": True})
    main_p, startup, loss, embs = cs.dlrm_program(args.batch)
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    data = cs.dlrm_batch(np.random.RandomState(3), args.batch)
    dense, label, ids = data
    fetch = [loss] + [e.grad_var(main_p) for e in embs]

    feed_s = [0.0]
    to_device = Executor._to_device

    def timed_to_device(self, *a, **k):
        t0 = time.perf_counter()
        out = to_device(self, *a, **k)
        feed_s[0] += time.perf_counter() - t0
        return out

    def step(split=None):
        t0 = time.perf_counter()
        feed = {"dense": dense, "label": label,
                "pairs": cs.dlrm_pairs(len(embs) + 1)}
        infos = []
        for e, bags in zip(embs, ids):
            f, info = e.prepare_feed_bags(bags)
            feed.update(f)
            infos.append(info)
        t1 = time.perf_counter()
        feed_s[0] = 0.0
        outs = exe.run(main_p, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)
        t2 = time.perf_counter()
        outs = [o.cpu().numpy() for o in outs]
        t3 = time.perf_counter()
        for e, info, g in zip(embs, infos, outs[1:]):
            e.push_grads(info, g)
        t4 = time.perf_counter()
        if split is not None:
            split.append((t1 - t0, feed_s[0], t2 - t1 - feed_s[0], t3 - t2,
                          t4 - t3))
        return float(outs[0].reshape(-1)[0])

    Executor._to_device = timed_to_device
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n, split, losses = args.steps, [], []
    for _ in range(n):
        losses.append(step(split))
    Executor._to_device = to_device
    parts = np.array(split) * 1e3
    total = parts.sum(1)
    print("DLRM, batch %d, %d tables, %d ops a step; %d steps: host %.3f "
          "ms/step (p50 %.3f); losses %s" % (
              args.batch, len(embs), len(main_p.global_block().ops), n,
              float(total.mean()), float(np.percentile(total, 50)),
              [round(x, 6) for x in losses]), flush=True)
    for i, name in enumerate(("pull", "feed", "run", "fetch", "push")):
        print("  host %-6s %9.3f ms/step (p50 %.3f)"
              % (name, float(parts[:, i].mean()),
                 float(np.percentile(parts[:, i], 50))))

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
    print("  device busy %.3f ms/step; idle share %.3f over the kernels' "
          "span; peak device memory %.2f GB"
          % (busy_us / 1e3 / n, 1.0 - busy_us / span_us, peak_gb),
          flush=True)
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        c = names.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += us
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  group %-52s %9.4f ms/step %5.1f%% of busy"
              % (g, us / 1e3 / n, 100.0 * us / busy_us))
    print("  device activities per step: %.1f; top by device time "
          "(count/step, ms/step):" % (len(kernels) / n))
    for name, (cnt, us) in sorted(names.items(),
                                  key=lambda kv: -kv[1][1])[:12]:
        print("    %6.1f %9.4f  %s" % (cnt / n, us / 1e3 / n, name[:100]))

    run_op = executor_mod.run_op
    host_by_type = collections.defaultdict(lambda: [0, 0.0])

    def clocked(op, *a, **k):
        t0 = time.perf_counter()
        run_op(op, *a, **k)
        c = host_by_type[op.type]
        c[0] += 1
        c[1] += time.perf_counter() - t0

    executor_mod.run_op = clocked
    for _ in range(n):
        step()
    executor_mod.run_op = run_op
    in_ops = sum(c[1] for c in host_by_type.values()) * 1e3 / n
    print("  host issuing ops: %.3f ms/step; by op type (ops/step, host "
          "ms/step):" % in_ops)
    for t, (cnt, sec) in sorted(host_by_type.items(),
                                key=lambda kv: -kv[1][1])[:12]:
        print("    %6.1f %9.4f  %s" % (cnt / n, sec * 1e3 / n, t))


if __name__ == "__main__":
    main()
