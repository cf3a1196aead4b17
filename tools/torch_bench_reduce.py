#!/usr/bin/env python3
"""Microbenchmark of the PyTorch port's channel statistics on the card:
does a hand-written column reduction read at the stream rate?

    python3 tools/torch_bench_reduce.py [--rep 64] [variant ...]

Counterpart of ``tools/bench_reduce_pallas.py``, with its shapes (the
batch-norm statistics of a ResNet-50 conv output at batch 512 in its
channels-last view, [N H W, C] bf16, 205 MB each) and its variants:

* ``stream``: y = y a chained over bf16 (one read, one write a pass), the
  bandwidth yardstick;
* ``torch``: the column sum and sum of squares of x + c with torch's own
  reductions (the reference's ``jnp`` variant);
* ``kernel``: the same through ``kernels/channel_stats.py`` ``stats``
  (row 16, the reference's ``pallas`` variant);
* ``fused``: y = x a + b written as bf16 with its column statistics, in
  torch and through ``affine_stats`` (row 17).

Each variant runs ``--rep`` passes chained on the device (a pass reads
the previous one's scalar carry or output, as the reference's scan does),
timed with CUDA events after one warm-up pass; it prints ms a pass and
the bytes a pass must move over that time, with the card's name and
power limit.  Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's SHAPES: [512 * 56 * 56, 64] and [512 * 28 * 28, 256]
SHAPES = {
    "c64": (512 * 56 * 56, 64),
    "c256": (512 * 28 * 28, 256),
}
VARIANTS = ("stream", "torch", "kernel", "fused")


def _timed(fn, rep):
    """ms a pass of ``rep`` chained passes of ``fn`` (after one warm-up)."""
    fn(1)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn(rep)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / rep


def _report(name, shape, ms, passes=1.0):
    m, c = shape
    gbs = m * c * 2 * passes / (ms * 1e-3) / 1e9
    print("%-32s %9.4f ms/pass %8.1f GB/s" % (name, ms, gbs), flush=True)
    return {"name": name, "ms": ms, "gb_s": gbs}


def run(variants=VARIANTS, rep=64, shapes=SHAPES):
    """Run the variants at every shape -> [{name, ms, gb_s}]."""
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import channel_stats as cst

    dev = torch.device("cuda")
    out = []
    for sname, shape in shapes.items():
        m, c = shape
        print("-- shape [%d, %d] bf16 (%.0f MB), %d passes"
              % (m, c, m * c * 2 / 1e6, rep), flush=True)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        a = torch.full((1, c), 1.0000001, device=dev)
        b = torch.zeros((1, c), device=dev)

        def carry(s, ss):
            return ((s.sum() + ss.sum()) * 1e-12).reshape(1, 1)

        if "stream" in variants:
            ab = torch.tensor(1.0000001, dtype=torch.bfloat16, device=dev)

            def stream(n):
                y = x
                for _ in range(n):
                    y = y * ab
                return y

            out.append(_report("torch stream 1r1w", shape,
                               _timed(stream, rep), passes=2.0))
        if "torch" in variants:
            def torch_stats(n):
                cv = torch.zeros((1, 1), device=dev)
                for _ in range(n):
                    xf = x.float() + cv
                    cv = carry(xf.sum(0), (xf * xf).sum(0))
                return cv

            out.append(_report("torch sum+sumsq (reduce)", shape,
                               _timed(torch_stats, rep)))
        if "kernel" in variants:
            def kernel_stats(n):
                cv = torch.zeros((1, 1), device=dev)
                for _ in range(n):
                    cv = carry(*cst.stats(x, cv))
                return cv

            out.append(_report("kernel sum+sumsq (row 16)", shape,
                               _timed(kernel_stats, rep)))
        if "fused" in variants:
            def torch_fused(n):
                y = x
                for _ in range(n):
                    yf = y.float() * a + b
                    y = yf.to(torch.bfloat16)
                    carry(yf.sum(0), (yf * yf).sum(0))
                return y

            def kernel_fused(n):
                y = x
                for _ in range(n):
                    y, _s, _ss = cst.affine_stats(y, a, b)
                return y

            out.append(_report("torch affine+stats", shape,
                               _timed(torch_fused, rep), passes=2.0))
            out.append(_report("kernel affine+stats (row 17)", shape,
                               _timed(kernel_fused, rep), passes=2.0))
        del x
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rep", type=int, default=64)
    ap.add_argument("variants", nargs="*",
                    help="any of %s (default: all)" % ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    bad = set(args.variants) - set(VARIANTS)
    if bad:
        ap.error("unknown variants %s" % sorted(bad))
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this measures the port on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s; %s" % (card, torch.cuda.get_device_name(0)),
          flush=True)
    run(args.variants or VARIANTS, args.rep)


if __name__ == "__main__":
    main()
