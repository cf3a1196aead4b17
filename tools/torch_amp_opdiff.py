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
from typing import NamedTuple

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


class OpByOp(NamedTuple):
    """What ``step_op_by_op`` found.  A row: (the largest difference
    relative to the CPU output's largest value, op index, op type, output
    name, the CPU's dtype, the card's dtype)."""
    iso: list        # each op on the card fed the CPU's inputs
    rows: dict       # {replay: rows of its chained outputs}
    first: dict      # {replay: (op index, type, output, gap) above 2^-7}
    loss: float      # the CPU's
    losses: dict     # {replay: the card's}
    cpu: dict        # the CPU's variables after the step
    envs: dict       # {replay: the card's variables after the step}
    steps: list      # the plan's (op, opdef, attrs)


def step_op_by_op(main_p, loss, feed, state, card, replays=None,
                  before_tail=None):
    """One step of ``main_p`` (its optimizer ops fused) from the
    persistables ``state`` (numpy), op by op: on the CPU (the yardstick),
    each op on ``card`` fed the CPU's inputs (isolated), and once per
    entry of ``replays`` (default ``{"chained": {}}``) chained on
    ``card``.  A replay's ``{op type: source}`` takes those ops' outputs
    instead of running them: "cpu" the CPU's, "isolated" the card's from
    the CPU's inputs, or ``{output slot: "cpu" | "isolated"}``.
    ``before_tail(i, envs)`` is called before the first optimizer op
    (index ``i`` of the plan's steps) with {replay: its variables} ->
    OpByOp."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import Executor
    from paddle_tpu_torch.core.lowering import (BlockPlan, draws, op_seed,
                                                run_op)

    replays = {"chained": {}} if replays is None else replays
    cpu_exe = Executor(framework.CPUPlace())
    cpu, card = torch.device("cpu"), torch.device(card)
    cenv = {n: torch.from_numpy(np.array(v)) for n, v in state.items()}
    cenv.update({n: torch.from_numpy(np.ascontiguousarray(v))
                 for n, v in feed.items()})
    # the executor's dtype of each feed (int64 ids, f32 data)
    block = main_p.global_block()
    for n in feed:
        cenv[n] = cpu_exe._to_device(n, cenv[n], block)
    envs = {k: {n: v.to(card, copy=True) for n, v in cenv.items()}
            for k in replays}
    steps = BlockPlan(block, list(feed), [loss.name]).steps
    tail = next((i for i, (op, _d, _a) in enumerate(steps)
                 if int(op.attrs.get("op_role", 0))
                 & framework.OpRole.Optimize), len(steps))
    iso_rows = []
    rows = {k: [] for k in replays}
    first = dict.fromkeys(replays)
    for i, (op, opdef, attrs) in enumerate(steps):
        if i == tail and before_tail is not None:
            before_tail(i, envs)
        seed = op_seed(0, 0, i) if draws(opdef, attrs) else None
        iso = {n: cenv[n].to(card, copy=True) for n in op.input_arg_names
               if n in cenv}
        run_op(op, opdef, attrs, cenv, cpu, seed)
        run_op(op, opdef, attrs, iso, card, seed)
        for k, env in envs.items():
            how = replays[k].get(op.type)
            if how is None:
                run_op(op, opdef, attrs, env, card, seed)
                continue
            for slot, names in op.outputs.items():
                src = how if isinstance(how, str) else how[slot]
                for n in names:
                    if n in cenv:
                        env[n] = cenv[n].to(card, copy=True) \
                            if src == "cpu" else iso[n]
        for n in op.output_arg_names:
            if not n or n not in cenv or not cenv[n].is_floating_point():
                continue
            want = cenv[n].to(card)
            iso_rows.append((rel(want, iso[n]), i, op.type, n,
                             str(cenv[n].dtype), str(iso[n].dtype)))
            for k, env in envs.items():
                r = rel(want, env[n])
                rows[k].append((r, i, op.type, n, str(cenv[n].dtype),
                                str(env[n].dtype)))
                if first[k] is None and r > 2 ** -7:
                    first[k] = (i, op.type, n, r)
    return OpByOp(iso_rows, rows, first,
                  float(cenv[loss.name].reshape(-1)[0]),
                  {k: float(env[loss.name].reshape(-1)[0])
                   for k, env in envs.items()}, cenv, envs, steps)


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
    got = step_op_by_op(main_p, loss, feed, scope_to_numpy(scope, main_p),
                        args.card)
    print("%s AMP, batch %d, state after %d CPU steps: %d float outputs"
          % (args.model, args.batch, args.cpu_steps, len(got.iso)))
    over = [r for r in got.iso if r[0] > 2 ** -7]
    print("isolated: %d outputs above 2^-7 of their largest value" %
          len(over))
    for r in sorted(got.iso, reverse=True)[:args.top]:
        print("  iso   %.3g  op %d %s %s %s (card %s)" % r)
    print("chained: first output above 2^-7: %s" % (got.first["chained"],))
    for r in sorted(got.rows["chained"], reverse=True)[:args.top]:
        print("  chain %.3g  op %d %s %s %s (card %s)" % r)
    print("loss: CPU %.6f, card chained %.6f"
          % (got.loss, got.losses["chained"]))


if __name__ == "__main__":
    main()
