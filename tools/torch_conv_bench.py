#!/usr/bin/env python3
"""Rows 11 and 12 (the conv-block kernels) against cuDNN at every conv
shape of ResNet-50.

    python3 tools/torch_conv_bench.py [--batch 32] [--sweep]

Lists the ``conv2d_bn_relu`` ops of chip_smoke.py's ResNet-50 trunk
(v1.5, 224x224: 53 convs of 23 distinct shapes) and, at each shape with
``--batch`` images (x ~ N(0, 1), weights at the layers' init, seeded),
times with CUDA events, L2 flushed before each call
(``chip_smoke.time_cold``):

* row 11, ``conv_bn_act`` (conv, folded affine, relu), and cuDNN's
  ``F.relu(F.conv2d(x, w a, b))`` with TF32 off;
* row 12, ``conv_stats`` (conv and per-image channel sums), and cuDNN's
  ``F.conv2d`` plus the two sums;

and prints each with its rate on the conv's 2 N C_out OH OW C kh kw
flops, the tile ``conv_tile`` picks and its CTAs per launch, and two
bounds: the f32 SIMT pipes (67 TF/s) and the kernel's own 3xTF32 design
(three TF32 products at 495 TF/s dense).  Then the launch-weighted
totals: row 11 over a served batch (each shape times its count) and row
12 over a training step, beside cuDNN's.  Each kernel's output is held
against its plain version (``CONV_ATOL``) before it is timed.
``--sweep`` also times both rows at every tile of ``TILES``, to check the
rule.  Ends with one JSON line of the readings.  Needs one CUDA card.
"""

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trunk_shapes(batch):
    """[((x shape, w shape, stride, pad), count)] of the ResNet-50 trunk's
    conv2d_bn_relu ops, in program order."""
    import chip_smoke as smoke

    main_p = smoke.resnet_program("trunk", True)[0]
    blk = main_p.global_block()
    shapes = collections.Counter()
    for op in blk.ops:
        if op.type == "conv2d_bn_relu":
            x = blk.var(op.input("Input")[0]).shape
            w = blk.var(op.input("Filter")[0]).shape
            shapes[((batch,) + tuple(x[1:]), tuple(w),
                    int(op.attr("strides")[0]),
                    int(op.attr("paddings")[0]))] += 1
    return list(shapes.items())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the kernels on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import conv_block as cb

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    f = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    occupancy = {}
    for i, (tm, tn) in enumerate(cb.TILES):
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
    for (xs, ws, stride, pad), count in trunk_shapes(args.batch):
        n, c, hw, _ = xs
        co, _, k, _ = ws
        x, w, a, b = smoke.conv_case(rng, n, c, hw, co, k, dev)
        oh = cb.out_size(hw, k, stride, pad)
        npix = n * oh * oh
        flops = 2.0 * npix * co * c * k * k
        tile = cb.conv_tile(co, npix)
        bm, bn = cb.TILES[tile]
        err11 = float((cb.conv_bn_act(x, w, a, b, stride, pad)
                       - cb.conv_bn_act_reference(x, w, a, b, stride, pad))
                      .abs().max())
        got, want = cb.conv_stats(x, w, stride, pad), \
            cb.conv_stats_reference(x, w, stride, pad)
        err12 = float((got[0] - want[0]).abs().max())
        srel = max(float((g - v).abs().max() / v.abs().max())
                   for g, v in zip(got[1:], want[1:]))
        if not (err11 <= smoke.CONV_ATOL and err12 <= smoke.CONV_ATOL
                and srel <= smoke.CONV_STATS_RTOL):
            sys.exit("kernel disagrees with its plain version at x %s w %s: "
                     "%.3g %.3g %.3g" % (xs, ws, err11, err12, srel))
        wa = (w * a.reshape(-1, 1, 1, 1)).contiguous()

        def lib_stats():
            cv = f.conv2d(x, w, stride=stride, padding=pad)
            return cv, cv.sum(dim=(2, 3)), (cv * cv).sum(dim=(2, 3))

        row = {
            "x": list(xs), "w": list(ws), "stride": stride, "pad": pad,
            "count": count, "tile": [bm, bn],
            "ctas": -(-co // bm) * -(-npix // bn), "gflop": flops / 1e9,
            "err": max(err11, err12),
            "row11_ms": smoke.time_cold(
                lambda: cb.conv_bn_act(x, w, a, b, stride, pad), flush),
            "cudnn11_ms": smoke.time_cold(
                lambda: f.relu(f.conv2d(x, wa, b, stride=stride,
                                        padding=pad)), flush),
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
        print("x %s w %s s%d p%d x%d: tile %dx%d, %d CTAs; row 11 %.6f ms "
              "(%.1f TF/s), cuDNN %.6f (%.1f); row 12 %.6f (%.1f), cuDNN + "
              "sums %.6f (%.1f); bounds f32 %.6f, 3xTF32 %.6f; err %.2e%s"
              % (xs, ws, stride, pad, count, bm, bn, row["ctas"],
                 row["row11_ms"], tf(row["row11_ms"]), row["cudnn11_ms"],
                 tf(row["cudnn11_ms"]), row["row12_ms"],
                 tf(row["row12_ms"]), row["cudnn12_ms"],
                 tf(row["cudnn12_ms"]), row["bound_f32_ms"],
                 row["bound_3xtf32_ms"], row["err"],
                 "".join("; %s %.6f / %.6f" % (t, *v)
                         for t, v in row.get("sweep", {}).items())),
              flush=True)
        rows.append(row)
        del x, w, a, b, wa, got, want
    total = {key: sum(r[key] * r["count"] for r in rows)
             for key in ("row11_ms", "cudnn11_ms", "row12_ms", "cudnn12_ms",
                         "gflop", "bound_f32_ms", "bound_3xtf32_ms")}
    print("launch-weighted over %d convs (%.1f GFLOP): served batch, row 11 "
          "%.4f ms (%.1f TF/s) against cuDNN %.4f (%.1f); training step, "
          "row 12 %.4f (%.1f) against cuDNN + sums %.4f (%.1f); bounds f32 "
          "%.4f, 3xTF32 %.4f" % (
              sum(r["count"] for r in rows), total["gflop"],
              total["row11_ms"], total["gflop"] / total["row11_ms"],
              total["cudnn11_ms"], total["gflop"] / total["cudnn11_ms"],
              total["row12_ms"], total["gflop"] / total["row12_ms"],
              total["cudnn12_ms"], total["gflop"] / total["cudnn12_ms"],
              total["bound_f32_ms"], total["bound_3xtf32_ms"]), flush=True)
    print(json.dumps({"conv_bench": {"card": smoke.card_line(),
                                     "batch": args.batch, "total": total,
                                     "ctas_per_sm": occupancy,
                                     "shapes": rows}}), flush=True)


if __name__ == "__main__":
    main()
