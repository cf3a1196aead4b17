#!/usr/bin/env python3
"""Where the card and the CPU part on one training step of an AMP program,
op by op, from one state.

    python3 tools/torch_amp_opdiff.py [--model resnet50|bert] [--batch N]
                                      [--cpu-steps K] [--top 12]

Builds the program (``resnet50``: the bundled ``build_train(amp=True)``,
224x224, 1000 classes, Momentum 0.9, L2Decay 1e-4, lr 0.0125; ``bert``:
BERT-base ``build_pretrain(amp=True)`` at seq 128), runs its startup and
``--cpu-steps`` steps on the CPU's plain path to reach a state, fuses its
optimizer ops as the Executor does, then runs one step op by op three
ways: on the CPU (the yardstick), on the card fed the CPU's inputs op by
op (isolated: what each op alone does), and on the card chained (what
the step does).  Prints, for each op output, the largest difference
relative to the output's largest value (a bf16 ulp is 2^-8 to 2^-7 of a
value), the isolated ops above 2^-7, the first chained output above
2^-7, the ``--top`` isolated and chained outputs, and the loss of the
chained step on each device.  Needs a CUDA card; the carry is off
(``FLAGS_layout_match_params`` changes no value).
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(model, batch):
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import bert, resnet

    main, startup = framework.Program(), framework.Program()
    startup.random_seed = 11
    rng = np.random.RandomState(4)
    with framework.program_guard(main, startup):
        if model == "resnet50":
            loss = resnet.build_train(depth=50, class_dim=1000,
                                      image_size=224, lr=0.0125,
                                      amp=True)[2]
            feed = {"img": rng.randn(batch, 3, 224, 224).astype(np.float32),
                    "label": rng.randint(0, 1000, (batch, 1))
                    .astype(np.int64)}
        else:
            cfg = bert.BertConfig()
            loss = bert.build_pretrain(cfg, 128, lr=1e-4, amp=True)[1]
            feed = bert.pretrain_feed(rng, cfg, batch, 128)
    return main, startup, loss, feed


def rel(a, b):
    """The largest |a - b| relative to the largest |a|, on b's device."""
    a, b = a.to(b.device).float(), b.float()
    scale = float(a.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-30)


def step_op_by_op(main_p, loss, feed, state, card, chained=True):
    """One step of ``main_p`` (its optimizer ops fused) from the
    persistables ``state`` (numpy), op by op, three ways: on the CPU, on
    ``card`` fed the CPU's inputs op by op, and (``chained``) on ``card``
    chained -> (isolated rows, chained rows, the first chained output
    above 2^-7, (the CPU's loss, the card's chained loss or None)).  A row: (the largest
    difference relative to the CPU output's largest value, op index, op
    type, output name, the CPU's dtype, the card's dtype)."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor
    from paddle_tpu_torch.core.lowering import (BlockPlan, draws, op_seed,
                                                run_op)

    cpu_exe = Executor(framework.CPUPlace())
    cpu, card = torch.device("cpu"), torch.device(card)
    cenv = {n: torch.from_numpy(np.array(v)) for n, v in state.items()}
    cenv.update({n: torch.from_numpy(np.ascontiguousarray(v))
                 for n, v in feed.items()})
    # the executor's dtype of each feed (int64 ids, f32 data)
    block = main_p.global_block()
    for n in feed:
        cenv[n] = cpu_exe._to_device(n, cenv[n], block)
    genv = {n: v.to(card) for n, v in cenv.items()} if chained else None
    plan = BlockPlan(block, list(feed), [loss.name])
    iso_rows, chain_rows, first = [], [], None
    for i, (op, opdef, attrs) in enumerate(plan.steps):
        seed = op_seed(0, 0, i) if draws(opdef, attrs) else None
        iso = {n: cenv[n].to(card) for n in op.input_arg_names
               if n in cenv}
        run_op(op, opdef, attrs, cenv, cpu, seed)
        run_op(op, opdef, attrs, iso, card, seed)
        if chained:
            run_op(op, opdef, attrs, genv, card, seed)
        for n in op.output_arg_names:
            if not n or n not in cenv or not cenv[n].is_floating_point():
                continue
            iso_rows.append((rel(cenv[n], iso[n]), i, op.type, n,
                             str(cenv[n].dtype), str(iso[n].dtype)))
            if not chained:
                continue
            r_chain = rel(cenv[n], genv[n])
            chain_rows.append((r_chain, i, op.type, n, str(cenv[n].dtype),
                               str(genv[n].dtype)))
            if first is None and r_chain > 2 ** -7:
                first = (i, op.type, n, r_chain)
    return iso_rows, chain_rows, first, (
        float(cenv[loss.name].reshape(-1)[0]),
        float(genv[loss.name].reshape(-1)[0]) if chained else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("resnet50", "bert"),
                    default="resnet50")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--cpu-steps", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--card", default="cuda",
                    help="the device held against the CPU")
    args = ap.parse_args()
    if args.card == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: this compares the card with the CPU")
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch import framework, set_f32_numerics, set_flags
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy

    set_f32_numerics()
    set_flags({"FLAGS_layout_match_params": False})
    main_p, startup, loss, feed = build(args.model, args.batch)
    cpu_exe = Executor(framework.CPUPlace())
    scope = Scope()
    cpu_exe.run(startup, scope=scope)
    for _ in range(args.cpu_steps):
        cpu_exe.run(main_p, feed=feed, fetch_list=[loss], scope=scope)
    cpu_exe._maybe_fuse_optimizers(main_p, list(feed), [loss.name])
    iso_rows, chain_rows, first, losses = step_op_by_op(
        main_p, loss, feed, scope_to_numpy(scope, main_p), args.card)
    print("%s AMP, batch %d, state after %d CPU steps: %d float outputs"
          % (args.model, args.batch, args.cpu_steps, len(iso_rows)))
    over = [r for r in iso_rows if r[0] > 2 ** -7]
    print("isolated: %d outputs above 2^-7 of their largest value" %
          len(over))
    for r in sorted(iso_rows, reverse=True)[:args.top]:
        print("  iso   %.3g  op %d %s %s %s (card %s)" % r)
    print("chained: first output above 2^-7: %s" % (first,))
    for r in sorted(chain_rows, reverse=True)[:args.top]:
        print("  chain %.3g  op %d %s %s %s (card %s)" % r)
    print("loss: CPU %.6f, card chained %.6f" % losses)


if __name__ == "__main__":
    main()
