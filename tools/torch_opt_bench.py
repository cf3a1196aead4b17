#!/usr/bin/env python3
"""The fused optimizer kernels on the card at their real groups: row 9,
the fused Adam over BERT-base's parameter group, and row 10, the fused
momentum over ResNet-50's fused group.

    python3 tools/torch_opt_bench.py [--root DIR] [--rows 9,10]

For each row: one step checked bitwise against its plain version, then
timed with CUDA events, L2 flushed before each call
(``chip_smoke.time_cold``), beside its one-call library counterpart
(``torch.optim.Adam(fused=True)``, another eps placement;
``torch.optim.SGD(momentum=0.9, fused=True)``, the same recurrence) and
its bytes bound at 3.35 TB/s (Adam: read p, g, m1, m2, write p, m1, m2;
momentum: read p, g, v, write p, v); and the wrapper's host time a call,
on the host clock over back-to-back calls (its checks, its launch
planning, the launch itself), beside the library call's.  Also the floor
of a cold-L2 timing (a one-element add timed the same way) and, for row
10, one PyTorch elementwise pass that moves the same bytes (``torch.mul(a,
2, out=b)``, 21 MB read and 21 MB written): what streaming those bytes
takes on the card under this timing.

``--root DIR`` times the kernels of the checkout at DIR (for example the
parent commit unpacked under build/, or a copy of the source with one
part changed), so that two trees can be timed in turns in one call to
the card.  Ends with one JSON line of the readings.  Needs one CUDA
card.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CALLS = 200


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds a call over ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def momentum_row(smoke, fm, dev, flush):
    gen = torch.Generator(dev).manual_seed(6)
    shapes = smoke.resnet50_fused_group()
    rand = lambda s, k: torch.randn(  # noqa: E731
        s, generator=gen, device=dev) * k
    p = [rand(s, 1.0) for s in shapes]
    g = [rand(s, 1e-2) for s in shapes]
    v = [rand(s, 1e-2) for s in shapes]
    lr = torch.tensor([0.1], device=dev)
    want = fm.fused_momentum_reference(p, g, v, lr, 0.9)
    run = ([x.clone() for x in p], g, [x.clone() for x in v], lr)
    before = fm.fused_momentum_step.launches
    got = fm.fused_momentum_step(*run, mu=0.9)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for gs, ws in zip(got[:2], want[:2])
               for a, b in zip(gs, ws)):
        sys.exit("fused_momentum not bitwise equal to its plain version")
    launches = fm.fused_momentum_step.launches - before
    lib_params = [x.clone().requires_grad_() for x in p]
    for x, gx in zip(lib_params, g):
        x.grad = gx
    lib = torch.optim.SGD(lib_params, lr=0.1, momentum=0.9, fused=True)
    nel = sum(x.numel() for x in p)
    # one PyTorch elementwise pass over the same bytes, read and written
    # once, as the card streams them
    a = torch.randn(nel * 5 // 2, generator=gen, device=dev)
    b = torch.empty_like(a)
    kernel = lambda: fm.fused_momentum_step(*run, mu=0.9)  # noqa: E731
    # a ~5 ms device sleep before each call covers any tree's host work
    # ahead of its launch, so the events bracket device work alone
    return {"kernel": "fused_momentum", "row": 10,
            "group": "ResNet-50, %d members, %d elements"
            % (len(p), nel), "launches": launches,
            "ms": smoke.time_cold(kernel, flush, sleep_cycles=10_000_000),
            "library_ms": smoke.time_cold(lib.step, flush,
                                          sleep_cycles=10_000_000),
            "copy_ms": smoke.time_cold(lambda: torch.mul(a, 2.0, out=b),
                                       flush),
            "bound_ms": smoke.bound(20 * nel, 3 * nel)[0],
            "host_us": host_us(kernel), "library_host_us": host_us(lib.step)}


def adam_row(smoke, fad, dev, flush):
    from paddle_tpu_torch.models.bert import BertConfig

    gen = torch.Generator(dev).manual_seed(5)
    shapes = smoke.bert_param_shapes(BertConfig())
    rand = lambda s, k: torch.randn(  # noqa: E731
        s, generator=gen, device=dev) * k
    n = len(shapes)
    grp = ([rand(s, 1.0) for s in shapes], [rand(s, 1e-3) for s in shapes],
           [rand(s, 1e-3) for s in shapes],
           [torch.rand(s, generator=gen, device=dev) * 1e-6
            for s in shapes], torch.tensor([1e-4], device=dev),
           [torch.tensor([0.9 ** (1 + i % 3)], device=dev)
            for i in range(n)],
           [torch.tensor([0.999 ** (1 + i % 5)], device=dev)
            for i in range(n)])

    def clones():
        p, g, m1, m2, lr, b1, b2 = grp
        c = lambda ts: [x.clone() for x in ts]  # noqa: E731
        return c(p), g, c(m1), c(m2), lr, c(b1), c(b2)

    want = fad.fused_adam_reference(*grp)
    before = fad.fused_adam_step.launches
    got = fad.fused_adam_step(*clones())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for gs, ws in zip(got[:5], want[:5])
               for a, b in zip(gs, ws)):
        sys.exit("fused_adam not bitwise equal to its plain version")
    launches = fad.fused_adam_step.launches - before
    del want, got
    run = clones()
    lib_params = [x.clone().requires_grad_() for x in grp[0]]
    for x, gx in zip(lib_params, grp[1]):
        x.grad = gx
    lib = torch.optim.Adam(lib_params, lr=1e-4, fused=True)
    nel = sum(x.numel() for x in grp[0])
    kernel = lambda: fad.fused_adam_step(*run)  # noqa: E731
    return {"kernel": "fused_adam", "row": 9,
            "group": "BERT-base, %d members, %d elements" % (n, nel),
            "launches": launches,
            "ms": smoke.time_cold(kernel, flush),
            "library_ms": smoke.time_cold(lib.step, flush),
            "bound_ms": smoke.bound(28 * nel, 12 * nel)[0],
            "host_us": host_us(kernel), "library_host_us": host_us(lib.step)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose kernels are timed")
    ap.add_argument("--rows", default="9,10",
                    help="rows to time: 9 (fused Adam), 10 (fused momentum)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this times the kernels on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.kernels import fused_momentum as fm

    set_f32_numerics()
    print("card: %s" % smoke.card_line(), flush=True)
    print("kernels of %s" % os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(fm.__file__)))), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    tiny = torch.zeros(1, device=dev)
    floor_ms = smoke.time_cold(lambda: tiny.add_(1.0), flush)
    print("floor (a one-element add, timed as the kernels are) %.6f ms"
          % floor_ms, flush=True)
    rows = [{"kernel": "floor", "ms": floor_ms}]
    rows_wanted = {int(r) for r in args.rows.split(",")}
    for num, fn in ((10, lambda: momentum_row(smoke, fm, dev, flush)),
                    (9, lambda: adam_row(smoke, fad, dev, flush))):
        if num not in rows_wanted:
            continue
        row = fn()
        print("row %d %s, %s: kernel %.6f ms (%d launch(es)), library "
              "%.6f, bound %.6f (bytes); host %.1f us a call, library's "
              "%.1f; bitwise equal to the plain version" % (
                  num, row["kernel"], row["group"], row["ms"],
                  row["launches"], row["library_ms"], row["bound_ms"],
                  row["host_us"], row["library_host_us"]), flush=True)
        if "copy_ms" in row:
            print("  one elementwise pass over the same bytes (torch.mul(a, "
                  "2, out=b)): %.6f ms" % row["copy_ms"], flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"opt_bench": rows}), flush=True)


if __name__ == "__main__":
    main()
