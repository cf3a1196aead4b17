#!/usr/bin/env python3
"""Rows 11, 12 and 13 (the conv-block kernels) and the batch-norm tail
between them at every conv shape of ResNet-50.

    python3 tools/torch_conv_bench.py [--batch 32] [--sweep]
        [--rows 11,12,13] [--root DIR]

Lists the ``conv2d_bn_relu`` ops of chip_smoke.py's ResNet-50 trunk
(v1.5, 224x224: 53 convs of 23 distinct shapes,
``chip_smoke.trunk_conv_shapes``) and, at each shape with ``--batch``
images (x ~ N(0, 1), weights at the layers' init, seeded), times with
CUDA events, L2 flushed before each call (``chip_smoke.time_cold``):

* row 11, ``conv_bn_act`` (conv, folded affine, relu), and cuDNN's
  ``F.relu(F.conv2d(x, w a, b))`` with TF32 off;
* row 12, ``conv_stats`` (conv and per-image channel sums), and cuDNN's
  ``F.conv2d`` plus the two sums;
* row 13, ``affine_act`` (the affine + relu pass over the conv), and
  ``F.relu(torch.addcmul(b, conv, a))``, with its bytes bound;
* the batch-norm tail of the training op: everything the
  ``conv2d_bn_relu`` op's kernel route does after row 12, from row 12's
  conv and sums to its five outputs (the fold of the batch statistics and
  row 13), run through the op's own lowering with row 12's result
  handed in; its device time (cold L2), its wall time back to back (the
  host's issue included), and the device operations it launches (counted
  once by torch.profiler).

Rows 11 and 12 print with their rate on the conv's 2 N C_out OH OW C kh
kw flops, the tile ``conv_tile`` picks and its CTAs per launch, and two
bounds: the f32 SIMT pipes (67 TF/s) and the kernel's own 3xTF32 design
(three TF32 products at 495 TF/s dense).  Then the launch-weighted
totals: row 11 over a served batch (each shape times its count), rows 12
and 13 and the tail over a training step.  Each kernel's output is held
against its plain version before it is timed.  ``--rows`` picks the rows
to time (the tail goes with 13); ``--sweep`` also times rows 11 and 12
at every tile of ``TILES``, to check the rule.  ``--root DIR`` times the
kernels and the op of the checkout at DIR (for example the parent commit
unpacked under build/), so that two trees can be timed in turns in one
call to the card.  Ends with one JSON line of the readings.  Needs one
CUDA card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tail_runner(cb, dev, xs, ws, stride, pad, conv, s, ss, rng):
    """-> (tail(), restore()): the conv2d_bn_relu op's training kernel
    route after row 12 (the checkout's own ``ops/nn.py``), with its
    ``conv_stats`` handing back (conv, s, ss)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx
    from paddle_tpu_torch.ops import nn as ops_nn

    set_flags({"FLAGS_use_pallas_conv_block": True})
    co = ws[0]
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    scale, bias = t(rng.uniform(0.5, 1.5, co)), t(rng.randn(co) * 0.1)
    mean, var = t(rng.randn(co) * 0.1), t(rng.uniform(0.5, 2.0, co))
    x = torch.empty(xs, device="meta")      # its shape is all it is read for
    w = torch.empty(ws, device="meta")
    lower = registry.get_op_def("conv2d_bn_relu").lower
    ctx = LowerCtx(dev)
    saved = ops_nn.conv_stats
    ops_nn.conv_stats = lambda *a, **k: (conv, s, ss)

    def restore():
        ops_nn.conv_stats = saved

    return (lambda: lower(ctx, x, w, scale, bias, mean, var,
                          strides=[stride, stride], paddings=[pad, pad],
                          momentum=0.9, epsilon=1e-5, is_test=False,
                          with_relu=True)), restore


def device_ops(fn, runs=5):
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches, counted by torch.profiler over ``runs`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA
               for e in prof.events()) / runs


def wall_ms(fn, runs=200):
    """Host-clock ms a call of ``fn`` back to back, to the last one's end:
    the larger of its issue time and its device time."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


def row13_and_tail(smoke, cb, dev, flush, xs, ws, stride, pad, conv, s, ss,
                   rng, tail_ops):
    """Row 13 alone and the whole tail at one shape -> readings."""
    f = torch.nn.functional
    n, co, oh, ow = conv.shape
    a, b = cb.fold_affine(*(torch.from_numpy(v.astype(np.float32)).to(dev)
                            for v in (rng.uniform(0.5, 1.5, co),
                                      rng.randn(co) * 0.1,
                                      rng.randn(co) * 0.1,
                                      rng.uniform(0.5, 2.0, co))), 1e-5)
    y = cb.affine_act(conv, a, b)
    torch.cuda.synchronize()
    if not torch.equal(y, cb.affine_act_reference(conv, a, b)):
        sys.exit("row 13 is not bitwise its plain version at %s" % (xs,))
    el = conv.numel()
    tail, restore = tail_runner(cb, dev, xs, ws, stride, pad, conv, s, ss,
                                rng)
    try:
        row = {"row13_ms": smoke.time_cold(lambda: cb.affine_act(conv, a, b),
                                           flush),
               "lib13_ms": smoke.time_cold(
                   lambda: f.relu(torch.addcmul(b.reshape(1, -1, 1, 1), conv,
                                                a.reshape(1, -1, 1, 1))),
                   flush),
               "bound13_ms": smoke.bound(4 * (2 * el + 2 * co), 3 * el)[0],
               "tail_ms": smoke.time_cold(tail, flush),
               "tail_wall_ms": wall_ms(tail)}
        if tail_ops is None:
            tail_ops = device_ops(tail)
    finally:
        restore()
    return row, tail_ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rows", default="11,12,13",
                    help="rows to time, of 11, 12, 13 (13 with the tail)")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose kernels and op are timed")
    args = ap.parse_args()
    timed = {int(r) for r in args.rows.split(",")}
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the kernels on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import conv_block as cb

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    print("kernels of %s" % os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(cb.__file__)))), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    occupancy = {}
    for i, (tm, tn) in enumerate(cb.TILES if timed & {11, 12} else ()):
        for stats in (False, True):
            for load, loader in enumerate(cb.LOADERS):
                occupancy["%dx%d %s %s" % (
                    tm, tn, "row 12" if stats else "row 11", loader)] = \
                    cb.ctas_per_sm(i, stats, load)
    print("CTAs per SM: %s" % "; ".join("%s %d" % kv
                                        for kv in occupancy.items()),
          flush=True)
    rng = np.random.RandomState(0)
    rows = []
    tail_ops = None
    for (xs, ws, stride, pad), count in smoke.trunk_conv_shapes(args.batch):
        n, c, hw, _ = xs
        co, _, k, _ = ws
        x, w, a, b = smoke.conv_case(rng, n, c, hw, co, k, dev)
        oh = cb.out_size(hw, k, stride, pad)
        npix = n * oh * oh
        flops = 2.0 * npix * co * c * k * k
        got = cb.conv_stats(x, w, stride, pad)
        row = {"x": list(xs), "w": list(ws), "stride": stride, "pad": pad,
               "count": count, "gflop": flops / 1e9}
        if timed & {11, 12}:
            row.update(conv_rows(smoke, cb, args, flush, x, w, a, b, stride,
                                 pad, got, flops))
        if 13 in timed:
            r13, tail_ops = row13_and_tail(smoke, cb, dev, flush, xs, ws,
                                           stride, pad, *got, rng, tail_ops)
            row.update(r13)
            print("x %s w %s s%d p%d x%d: row 13 %.6f ms, addcmul + relu "
                  "%.6f, bound %.6f (bytes); the tail after row 12 %.6f ms "
                  "on the card, %.6f back to back on the host clock"
                  % (xs, ws, stride, pad, count, row["row13_ms"],
                     row["lib13_ms"], row["bound13_ms"], row["tail_ms"],
                     row["tail_wall_ms"]), flush=True)
        rows.append(row)
        del x, w, a, b, got
    keys = ["gflop"]
    if timed & {11, 12}:
        keys += ["row11_ms", "cudnn11_ms", "row12_ms", "cudnn12_ms",
                 "bound_f32_ms", "bound_3xtf32_ms"]
    if 13 in timed:
        keys += ["row13_ms", "lib13_ms", "bound13_ms", "tail_ms",
                 "tail_wall_ms"]
    total = {key: sum(r[key] * r["count"] for r in rows) for key in keys}
    convs = sum(r["count"] for r in rows)
    if timed & {11, 12}:
        print("launch-weighted over %d convs (%.1f GFLOP): served batch, "
              "row 11 %.4f ms (%.1f TF/s) against cuDNN %.4f (%.1f); "
              "training step, row 12 %.4f (%.1f) against cuDNN + sums %.4f "
              "(%.1f); bounds f32 %.4f, 3xTF32 %.4f" % (
                  convs, total["gflop"],
                  total["row11_ms"], total["gflop"] / total["row11_ms"],
                  total["cudnn11_ms"], total["gflop"] / total["cudnn11_ms"],
                  total["row12_ms"], total["gflop"] / total["row12_ms"],
                  total["cudnn12_ms"], total["gflop"] / total["cudnn12_ms"],
                  total["bound_f32_ms"], total["bound_3xtf32_ms"]),
              flush=True)
    if 13 in timed:
        total["tail_device_ops"] = tail_ops * convs
        print("launch-weighted over %d convs (a training step): row 13 "
              "%.4f ms against addcmul + relu %.4f and its bound %.4f "
              "(bytes); the tail after row 12 %.4f ms on the card, %.4f "
              "back to back on the host clock, %.1f device operations a "
              "conv (%d a step)" % (
                  convs, total["row13_ms"], total["lib13_ms"],
                  total["bound13_ms"], total["tail_ms"],
                  total["tail_wall_ms"], tail_ops, round(tail_ops * convs)),
              flush=True)
    print(json.dumps({"conv_bench": {"card": smoke.card_line(),
                                     "root": os.path.abspath(args.root),
                                     "batch": args.batch, "total": total,
                                     "ctas_per_sm": occupancy,
                                     "shapes": rows}}), flush=True)


def conv_rows(smoke, cb, args, flush, x, w, a, b, stride, pad, got, flops):
    """Rows 11 and 12 at one shape, held to their plain versions first ->
    readings."""
    f = torch.nn.functional
    n, co = x.shape[0], w.shape[0]
    oh = got[0].shape[2]
    npix = n * oh * oh
    tile = cb.conv_tile(co, npix)
    bm, bn = cb.TILES[tile]
    err11 = float((cb.conv_bn_act(x, w, a, b, stride, pad)
                   - cb.conv_bn_act_reference(x, w, a, b, stride, pad))
                  .abs().max())
    want = cb.conv_stats_reference(x, w, stride, pad)
    err12 = float((got[0] - want[0]).abs().max())
    srel = max(float((g - v).abs().max() / v.abs().max())
               for g, v in zip(got[1:], want[1:]))
    if not (err11 <= smoke.CONV_ATOL and err12 <= smoke.CONV_ATOL
            and srel <= smoke.CONV_STATS_RTOL):
        sys.exit("kernel disagrees with its plain version at x %s w %s: "
                 "%.3g %.3g %.3g" % (tuple(x.shape), tuple(w.shape), err11,
                                     err12, srel))
    wa = (w * a.reshape(-1, 1, 1, 1)).contiguous()

    def lib_stats():
        cv = f.conv2d(x, w, stride=stride, padding=pad)
        return cv, cv.sum(dim=(2, 3)), (cv * cv).sum(dim=(2, 3))

    row = {
        "tile": [bm, bn], "ctas": -(-co // bm) * -(-npix // bn),
        "err": max(err11, err12),
        "row11_ms": smoke.time_cold(
            lambda: cb.conv_bn_act(x, w, a, b, stride, pad), flush),
        "cudnn11_ms": smoke.time_cold(
            lambda: f.relu(f.conv2d(x, wa, b, stride=stride, padding=pad)),
            flush),
        "row12_ms": smoke.time_cold(
            lambda: cb.conv_stats(x, w, stride, pad), flush),
        "cudnn12_ms": smoke.time_cold(lib_stats, flush),
        "bound_f32_ms": flops / smoke.F32_FLOPS * 1e3,
        "bound_3xtf32_ms": 3 * flops / smoke.TF32_FLOPS * 1e3}
    if args.sweep:
        row["sweep"] = {}
        for i, (tm, tn) in enumerate(cb.TILES):
            row["sweep"]["%dx%d" % (tm, tn)] = [
                smoke.time_cold(lambda: cb._conv_bn_act(
                    x, w, a, b, stride, pad, True, i), flush),
                smoke.time_cold(lambda: cb._conv_stats(
                    x, w, stride, pad, i), flush)]
    tf = lambda ms: flops / ms / 1e9  # noqa: E731
    print("x %s w %s s%d: tile %dx%d, %d CTAs; row 11 %.6f ms (%.1f TF/s), "
          "cuDNN %.6f (%.1f); row 12 %.6f (%.1f), cuDNN + sums %.6f (%.1f); "
          "bounds f32 %.6f, 3xTF32 %.6f; err %.2e%s"
          % (tuple(x.shape), tuple(w.shape), stride, bm, bn, row["ctas"],
             row["row11_ms"], tf(row["row11_ms"]), row["cudnn11_ms"],
             tf(row["cudnn11_ms"]), row["row12_ms"], tf(row["row12_ms"]),
             row["cudnn12_ms"], tf(row["cudnn12_ms"]), row["bound_f32_ms"],
             row["bound_3xtf32_ms"], row["err"],
             "".join("; %s %.6f / %.6f" % (t, *v)
                     for t, v in row.get("sweep", {}).items())), flush=True)
    return row


if __name__ == "__main__":
    main()
