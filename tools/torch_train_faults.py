#!/usr/bin/env python3
"""How far chip_smoke.py's training check moves when the card's training
path is wrong: the gaps it reads, sound and with faults planted.

    python3 tools/torch_train_faults.py

Builds BERT-base pretraining (dropout 0, seq 128, Adam at lr 1e-4,
seeded random weights) as chip_smoke.py's training phase does, and runs
that phase's comparison (``chip_smoke.card_vs_cpu``: 3 steps at batch 2
from one initial state, card against the port's plain path on the CPU)
once as the code stands and once under each planted fault:

* ``adam not launched``: the fused-Adam kernel does nothing, so
  parameters, moments and beta pows keep their values;
* ``dK zeroed``: the fused backward kernel's dK is replaced by zeros;
* ``dQ, dK swapped``: the attention grad hands dK out as dQ and back;
* ``fused-LN dY zeroed``: the fused-LN backward's dY (the residual
  branch's gradient, one tensor with dX at dropout 0) is zeros.

The faults are patched in at run time and only on the card's side: the
CPU runs the plain versions, which the patches do not reach.  Prints
each case's loss gap and Adam-moment gap beside chip_smoke.py's limits,
then one JSON line of the readings.  Needs one CUDA card.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def faults():
    """{case: context manager factory} of the planted faults."""
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.ops import nn as ops_nn

    real_kernel = fad._kernel
    real_fused = fa.flash_attention_bwd_fused
    real_bwd = ops_nn.flash_attention_bwd
    real_ln_bwd = ops_nn.fused_ln_bwd

    def idle_adam():
        real_kernel()                  # built as usual, then never run
        return lambda *args: 0

    def fused_zero_dk(*args, **kw):
        dq, dk, dv = real_fused(*args, **kw)
        return dq, torch.zeros_like(dk), dv

    # the wrapper counts its launches on the module's name, now this one
    fused_zero_dk.launches = 0

    def bwd_swapped(*args, **kw):
        dq, dk, dv = real_bwd(*args, **kw)
        if not dq.is_cuda:
            return dq, dk, dv
        return dk, dq, dv

    def ln_bwd_zero_dy(*args, **kw):
        dx, dy, dg, db = real_ln_bwd(*args, **kw)
        if not dx.is_cuda:
            return dx, dy, dg, db
        return dx, torch.zeros_like(dy), dg, db

    return {
        "sound": contextlib.nullcontext,
        "adam not launched": lambda: patched(fad, "_kernel", idle_adam),
        "dK zeroed": lambda: patched(fa, "flash_attention_bwd_fused",
                                     fused_zero_dk),
        "dQ, dK swapped": lambda: patched(ops_nn, "flash_attention_bwd",
                                          bwd_swapped),
        "fused-LN dY zeroed": lambda: patched(ops_nn, "fused_ln_bwd",
                                              ln_bwd_zero_dy),
    }


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this plants faults on the card")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from paddle_tpu_torch import framework, set_f32_numerics
    from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.bert import (BertConfig, build_pretrain,
                                              pretrain_feed)

    set_f32_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print("card: %s" % card, flush=True)
    _build.build_all()
    cfg = BertConfig(dropout=0.0)
    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 11
    with framework.program_guard(main_p, startup):
        _inputs, loss = build_pretrain(cfg, smoke.SEQ, lr=1e-4)
    scope = Scope()
    Executor().run(startup, scope=scope)
    init = scope_to_numpy(scope, main_p)
    del scope
    feed = pretrain_feed(np.random.RandomState(4), cfg, smoke.CHECK_BATCH,
                         smoke.SEQ)
    readings = {}
    for case, fault in faults().items():
        with fault():
            loss_gap, moment_gap, worst = smoke.card_vs_cpu(main_p, loss,
                                                            init, feed)
        caught = not (loss_gap <= smoke.TRAIN_LOSS_ATOL
                      and moment_gap <= smoke.TRAIN_MOMENT_RTOL)
        readings[case] = {"loss_gap": loss_gap, "moment_gap": moment_gap,
                          "worst": worst, "caught": caught}
        print("%-20s loss gap %.6g (limit %.3g), moment gap %.6g (limit "
              "%.3g, worst %s): %s"
              % (case, loss_gap, smoke.TRAIN_LOSS_ATOL, moment_gap,
                 smoke.TRAIN_MOMENT_RTOL, worst,
                 "caught" if caught else "passes"), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
