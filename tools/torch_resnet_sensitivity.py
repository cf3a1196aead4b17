#!/usr/bin/env python3
"""How far two f32 implementations of a ResNet-50 training step part, on
the CPU's plain path: the floor under chip_smoke.py's card-vs-CPU check.

    python3 tools/torch_resnet_sensitivity.py lr [--image 112] [--batch 16]
    python3 tools/torch_resnet_sensitivity.py algorithms [--image 224]
        [--batch 2] [--which bundled trunk]

Builds ResNet-50 as chip_smoke.py does (``resnet_program``: seeded
random weights, Momentum 0.9 with L2Decay 1e-4) and runs it through the
port's Executor on the CPU.

* ``lr``: 5 steps on one batch at build_train's lr 0.1 and at the
  smoke's 0.0125 (0.1 per 256 images), from one initial state: the
  losses.
* ``algorithms``: the same steps with PyTorch's oneDNN convolutions on
  and off (two summation orders of the same f32 arithmetic), for 3
  steps chained from one state (the loss gap), and for 3 steps each
  started from one state (the chain of the oneDNN run): the loss gap,
  each velocity's norm-wise relative gap, and after the first step the
  largest element gap of a velocity relative to its largest element.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(which, image, lr=None):
    import chip_smoke as cs
    from paddle_tpu_torch import framework, set_flags
    from paddle_tpu_torch.core import (Executor, Scope, scope_guard,
                                       scope_to_numpy)

    cs.IMAGE = image
    if lr is not None:
        cs.RESNET_LR = lr
    set_flags({"FLAGS_use_pallas_conv_block": which == "trunk"})
    main_p, startup, _img, _label, loss = cs.resnet_program(which, False)
    exe, scope = Executor(framework.CPUPlace()), Scope()
    with scope_guard(scope):
        exe.run(startup)
    return cs, main_p, loss, exe, scope_to_numpy(scope, main_p)


def _steps(main_p, loss, exe, state, feed, n, onednn=True):
    """n steps from ``state`` -> (losses, scope after them)."""
    from paddle_tpu_torch.core import Scope, scope_from_numpy

    torch.backends.mkldnn.enabled = onednn
    sc = scope_from_numpy(Scope(), state, "cpu", program=main_p)
    out = [float(exe.run(main_p, feed=feed, fetch_list=[loss],
                         scope=sc)[0].reshape(-1)[0]) for _ in range(n)]
    return out, sc


def _velocity_gaps(a, b, names):
    """(largest norm-wise gap, its tensor, largest element gap relative
    to the tensor's largest element, its tensor) of b's velocities
    against a's."""
    norm, elem = (0.0, None), (0.0, None)
    for n in names:
        va = a.find_var(n).get_tensor().numpy()
        vb = b.find_var(n).get_tensor().numpy()
        scale = float(np.abs(vb).max())
        if scale == 0.0:
            continue
        rn = float(np.linalg.norm(va - vb)) / float(np.linalg.norm(vb))
        re = float(np.abs(va - vb).max()) / scale
        norm = max(norm, (rn, n))
        elem = max(elem, (re, n))
    return norm + elem


def run_lr(args):
    for lr in (0.1, 0.0125):
        cs, main_p, loss, exe, init = _setup("bundled", args.image, lr)
        feed = cs.resnet_feed(np.random.RandomState(3), args.batch)
        losses, _sc = _steps(main_p, loss, exe, init, feed, 5)
        print("lr %g, %dx%d, batch %d, 5 steps on one batch: losses %s"
              % (lr, args.image, args.image, args.batch,
                 [round(x, 4) for x in losses]), flush=True)


def run_algorithms(args):
    from paddle_tpu_torch.core import scope_to_numpy

    for which in args.which:
        cs, main_p, loss, exe, init = _setup(which, args.image)
        feed = cs.resnet_feed(np.random.RandomState(4), args.batch)
        vel = [n for n in init if "_velocity_" in n]
        a, _sa = _steps(main_p, loss, exe, init, feed, 3, True)
        b, _sb = _steps(main_p, loss, exe, init, feed, 3, False)
        print("%s, %dx%d, batch %d: 3 chained steps, oneDNN on %s, off %s: "
              "largest loss gap %.3g" % (
                  which, args.image, args.image, args.batch,
                  [round(x, 6) for x in a], [round(x, 6) for x in b],
                  max(abs(x - y) for x, y in zip(a, b))), flush=True)
        state = init
        for k in range(3):
            (la,), sa = _steps(main_p, loss, exe, state, feed, 1, True)
            (lb,), sb = _steps(main_p, loss, exe, state, feed, 1, False)
            rn, nn, re, ne = _velocity_gaps(sa, sb, vel)
            print("  step %d from one state: losses %.7f / %.7f, gap %.3g; "
                  "velocities' largest norm-wise gap %.3g (%s); largest "
                  "element gap %.3g of the tensor's largest (%s)"
                  % (k + 1, la, lb, abs(la - lb), rn, nn, re, ne),
                  flush=True)
            state = scope_to_numpy(sa, main_p)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("lr", "algorithms"))
    ap.add_argument("--image", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--which", nargs="+", default=["bundled", "trunk"],
                    choices=["bundled", "trunk"])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.mode == "lr":
        args.image, args.batch = args.image or 112, args.batch or 16
        run_lr(args)
    else:
        args.image, args.batch = args.image or 224, args.batch or 2
        run_algorithms(args)


if __name__ == "__main__":
    main()
