#!/usr/bin/env python3
"""Where a ResNet-50 training step and a served ResNet-50 batch of the
PyTorch port spend their time on the card.

    python3 tools/torch_conv_profile.py [--steps 5] [--batch 32]
        [--which train-bundled train-trunk serve-bundled serve-trunk]
        [--root DIR]

Builds ResNet-50 v1.5 (224x224, 1000 classes, NCHW f32, seeded random
weights) as chip_smoke.py does (``resnet_program``): ``bundled`` is the
port's ``models/resnet.py`` (conv2d + batch_norm pairs), ``trunk`` the
same architecture with each pair one ``conv2d_bn_relu`` op, run under
``FLAGS_use_pallas_conv_block`` (the conv-block kernels, rows 11-13).
``train-*`` runs the training program (Momentum with L2 decay) through
the port's Executor on the card, step after step on one fixed batch;
``serve-*`` saves the inference program and runs the predictor (its
passes applied) on one batch of ``--batch`` images, as a serving bucket
does.  After warm-up it times ``--steps`` runs on the host clock, then
records as many with torch.profiler and prints the device busy time per
run, the device's idle share over the kernels' span, peak device memory,
and the device time split into cuDNN / cuBLAS (the convs and the fc),
the conv-block kernels (rows 11, 12, 13, and the fold of the batch
statistics between 12 and 13), the fused momentum (row 10) and the rest
(batch norm, elementwise, pooling, copies); then the host time by op
type.  ``--root DIR`` runs the port of the checkout at DIR (for example
the parent commit unpacked under build/), so that two trees can be
profiled in turns in one call to the card.  Needs one CUDA card.
"""

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ROW11 = "ported: row 11 conv + BN + relu"
_ROW12 = "ported: row 12 conv + channel sums"
# kernel name patterns of the ported kernels (csrc/conv_block.cu: the conv
# core's instantiations conv_mma_kernel<BM, BN, WM, WN, kStats, kLoad>;
# csrc/fused_momentum.cu), checked before the library's
_PORTED = ((r"conv_mma_kernel<\d+, \d+, \d+, \d+, false", _ROW11),
           (r"conv_mma_kernel<\d+, \d+, \d+, \d+, true", _ROW12),
           ("stats_reduce", _ROW12),
           ("affine_act", "ported: row 13 affine + relu"),
           ("bn_fold", "ported: the batch-statistics fold"),
           ("fused_momentum", "ported: row 10 fused momentum"))
# the weight reorder of the tap-major loader, which rows 11 and 12 launch
# before their conv: a served batch runs row 11, a training step row 12
_REORDER = {"serve": _ROW11, "train": _ROW12}
_LIBRARY = ("conv", "xmma", "implicit", "gemm", "gemv", "cudnn", "dgrad",
            "wgrad", "fprop", "cutlass", "winograd", "fft")


def _group(name, mode):
    if "tap_major_kernel" in name:
        return _REORDER[mode]
    for pattern, group in _PORTED:
        if re.search(pattern, name):
            return group
    n = name.lower()
    if any(f in n for f in _LIBRARY):
        return "cuDNN / cuBLAS (convs, their grads, the fc)"
    return "other kernels (batch norm, elementwise, pooling, copies)"


def _runner(which, batch, tmp):
    """-> (run(), ops in the program run) for one configuration."""
    import chip_smoke as cs
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import Executor, Scope, scope_guard
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor

    mode, program = which.split("-")
    main_p, startup, img, _label, out = cs.resnet_program(
        program, mode == "serve")
    rng = np.random.RandomState(3)
    feed = cs.resnet_feed(rng, batch)
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    if mode == "train":
        return (lambda: exe.run(main_p, feed=feed, fetch_list=[out],
                                scope=scope)[0],
                main_p.global_block().ops)
    dirname = os.path.join(tmp, which)
    with scope_guard(scope):
        io.save_inference_model(dirname, [img.name], [out], exe,
                                main_program=main_p)
    cfg = AnalysisConfig(dirname)
    pred = AnalysisPredictor(cfg)
    x = {img.name: feed["img"]}
    return (lambda: pred.run_feed(x),
            pred.program().global_block().ops)


def profile_one(which, args, tmp):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import set_flags

    set_flags({"FLAGS_use_pallas_conv_block": which.endswith("trunk")})
    run, ops = _runner(which, args.batch, tmp)
    for _ in range(args.warmup):     # fuses the optimizer ops, plans
        run()
    torch.cuda.synchronize()
    n = args.steps
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()                         # the output copy-back synchronizes
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = max(e.time_range.end for e in kernels) \
        - min(e.time_range.start for e in kernels)
    print("ResNet-50 %s, batch %d, 224x224: %d ops a run; %d runs: host "
          "%.3f ms/run unprofiled (p50 %.3f); device busy %.3f ms/run; "
          "device idle share %.3f over the kernels' span; peak device "
          "memory %.2f GB" % (which, args.batch, len(ops), n,
                              float(np.mean(host)),
                              float(np.percentile(host, 50)),
                              busy_us / 1e3 / n, 1.0 - busy_us / span_us,
                              peak_gb), flush=True)
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = _group(e.name, which.split("-")[0])
        groups[g] = groups.get(g, 0.0) + us
        c = names.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += us
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  group %-52s %9.4f ms/run %5.1f%% of busy"
              % (g, us / 1e3 / n, 100.0 * us / busy_us))
    reorder = [v for k, v in names.items() if "tap_major_kernel" in k]
    if reorder:
        print("  of it the tap-major weight reorder: %.1f launches/run, "
              "%.4f ms/run" % (sum(c for c, _ in reorder) / n,
                               sum(us for _, us in reorder) / 1e3 / n))
    print("  kernels per run: %.1f; top by device time (launches/run, "
          "ms/run):" % (len(kernels) / n))
    for name, (cnt, us) in sorted(names.items(),
                                  key=lambda kv: -kv[1][1])[:12]:
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
        run()
    wall = (time.perf_counter() - t0) * 1e3 / n
    executor_mod.run_op = run_op
    in_ops = sum(c[1] for c in host_by_type.values()) * 1e3 / n
    print("  host: %.3f ms/run, %.3f of it issuing ops; by op type "
          "(ops/run, host ms/run):" % (wall, in_ops))
    for t, (cnt, sec) in sorted(host_by_type.items(),
                                key=lambda kv: -kv[1][1]):
        print("    %6.1f %9.4f  %s" % (cnt / n, sec * 1e3 / n, t))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--which", nargs="+",
                    default=["train-bundled", "train-trunk",
                             "serve-bundled", "serve-trunk"],
                    choices=["train-bundled", "train-trunk",
                             "serve-bundled", "serve-trunk"])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose port is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this profiles the port on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke  # noqa: F401  (this checkout's, before DIR's)
    sys.path.insert(0, os.path.abspath(args.root))
    print("port of %s" % os.path.abspath(args.root), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s" % card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for which in args.which:
            profile_one(which, args, tmp)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
