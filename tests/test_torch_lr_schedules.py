"""The PyTorch port's learning-rate schedules held against the JAX
package on the CPU.

* Each schedule of ``SCHEDULES`` (exponential, natural_exp and
  inverse_time decay, each also with ``staircase``; polynomial decay at
  powers 1 and 2 and with ``cycle``; piecewise; cosine; linear warmup to
  a constant and over a polynomial decay; noam): the port's main and
  startup programs equal the reference's through ``to_dict()`` (every op
  under the LRSched role, the one step counter ``@LR_DECAY_COUNTER@``),
  and the learning rate fetched at each of 30 steps equals the
  reference's to LR_RTOL, or LR_ULPS ulps of the schedule's largest rate
  (the same f32 ops, but XLA and PyTorch may round exp, pow and cos one
  ulp apart, and XLA fuses a ``scale`` into one multiply-add, which
  rounds once where PyTorch rounds twice: polynomial decay's end rate
  0.001 reads 1.5e-6 apart, 1.5e-9 absolute), and the closed form in
  float64 to FORM_RTOL.  The port's learning rate stays a [1] f32
  tensor on the executor's device.
* ResNet-18 (the bundled ``resnet``, 32x32 images, 10 classes, batch 8)
  under ``LarsMomentum(0.9)`` and a piecewise decay takes 5 steps from
  the reference's initial state: the losses equal the reference's to
  LOSS_ATOL, the learning rate at each step the reference's.
"""

import math

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import resnet as jres
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.utils import unique_name as tun

STEPS = 30
LR_RTOL = 1e-6
LR_ULPS = 2
EPS32 = float(np.finfo(np.float32).eps)
FORM_RTOL = 1e-5
LOSS_ATOL = 1e-4


def _poly(t, lr, steps, end, power, cycle=False):
    if cycle:
        # the cycle count from the f32 ratio the program computes: at a
        # multiple of steps, t * f32(1 / steps) may round above 1
        ratio = float(np.float32(t) * np.float32(1.0 / steps))
        steps = steps * max(math.ceil(ratio), 1)
    else:
        t = min(t, steps)
    return (lr - end) * (1 - t / steps) ** power + end


# name -> (schedule builder over a layers module, closed form of step t)
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 5, 0.5),
                    lambda t: 0.1 * 0.5 ** (t / 5)),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 5, 0.5, staircase=True),
        lambda t: 0.1 * 0.5 ** (t // 5)),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 5, 0.3),
                    lambda t: 0.1 * math.exp(-0.3 * t / 5)),
    "natural_exp_staircase": (
        lambda L: L.natural_exp_decay(0.1, 5, 0.3, staircase=True),
        lambda t: 0.1 * math.exp(-0.3 * (t // 5))),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 5, 0.5),
                     lambda t: 0.1 / (1 + 0.5 * t / 5)),
    "inverse_time_staircase": (
        lambda L: L.inverse_time_decay(0.1, 5, 0.5, staircase=True),
        lambda t: 0.1 / (1 + 0.5 * (t // 5))),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 20, 0.001),
                   lambda t: _poly(t, 0.1, 20, 0.001, 1.0)),
    "polynomial_power2": (
        lambda L: L.polynomial_decay(0.1, 20, 0.0, power=2.0),
        lambda t: _poly(t, 0.1, 20, 0.0, 2.0)),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 7, 0.001, cycle=True),
        lambda t: _poly(t, 0.1, 7, 0.001, 1.0, cycle=True)),
    "piecewise": (
        lambda L: L.piecewise_decay([5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
        lambda t: [0.1, 0.05, 0.01, 0.001][sum(t >= b for b in (5, 12, 20))]),
    "cosine": (lambda L: L.cosine_decay(0.1, 4, 10),
               lambda t: 0.05 * (math.cos(math.pi * (t // 4) / 10) + 1)),
    "warmup": (lambda L: L.linear_lr_warmup(0.1, 8, 0.0, 0.1),
               lambda t: 0.1 * t / 8 if t < 8 else 0.1),
    "warmup_polynomial": (
        lambda L: L.linear_lr_warmup(L.polynomial_decay(0.1, 20, 0.0), 8,
                                     0.0, 0.1),
        lambda t: 0.1 * t / 8 if t < 8 else _poly(t, 0.1, 20, 0.0, 1.0)),
    "noam": (lambda L: L.learning_rate_scheduler.noam_decay(64, 10),
             lambda t: 64 ** -0.5 * min((t + 1) ** -0.5,
                                        (t + 1) * 10 ** -1.5)),
}


def programs(fw, L, un, name):
    main, startup = fw.Program(), fw.Program()
    with un.guard(), fw.program_guard(main, startup):
        lr = SCHEDULES[name][0](L)
    return main, startup, lr


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_programs_equal_reference(name):
    jm, js, _ = programs(fluid, fluid.layers, jun, name)
    tm, ts, _ = programs(tfw, tlayers, tun, name)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ops = tm.global_block().ops
    assert all(op.attr("op_role") == tfw.OpRole.LRSched for op in ops)
    assert sum(op.type == "increment" for op in ops) == 1


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_equal_reference(name):
    jm, js, jlr = programs(fluid, fluid.layers, jun, name)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        want = [float(np.asarray(exe.run(jm, fetch_list=[jlr])[0])
                      .ravel()[0]) for _ in range(STEPS)]
    tm, ts, tlr = programs(tfw, tlayers, tun, name)
    texe, tscope = Executor(tfw.CPUPlace()), Scope()
    texe.run(ts, scope=tscope)
    got = []
    for _ in range(STEPS):
        out, = texe.run(tm, fetch_list=[tlr], scope=tscope,
                        return_numpy=False)
        assert tuple(out.shape) == (1,) and str(out.dtype) == "torch.float32"
        got.append(float(out[0]))
    np.testing.assert_allclose(got, want, rtol=LR_RTOL,
                               atol=LR_ULPS * EPS32 * max(want))
    form = [SCHEDULES[name][1](t) for t in range(STEPS)]
    np.testing.assert_allclose(got, form, rtol=FORM_RTOL, atol=1e-9)


# -- ResNet-18 under LARS and a piecewise decay --------------------------------

IMG, CLASSES, BATCH, TRAIN_STEPS = 32, 10, 8, 5


def lars_resnet(fw, L, opt, res, un):
    main, startup = fw.Program(), fw.Program()
    startup.random_seed = 5
    with un.guard(), fw.program_guard(main, startup):
        img = L.data("img", shape=[3, IMG, IMG])
        label = L.data("label", shape=[1], dtype="int64")
        logits = res.resnet(img, CLASSES, 18)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        lr = L.piecewise_decay([2, 4], [2.0, 1.0, 0.5])
        opt.LarsMomentum(lr, momentum=0.9).minimize(loss)
    return main, startup, loss, lr


def test_resnet18_under_lars_and_piecewise_trains_as_the_reference():
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(BATCH, 3, IMG, IMG).astype(np.float32),
            "label": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}
    jm, js, jloss, jlr = lars_resnet(fluid, fluid.layers, fluid.optimizer,
                                     jres, jun)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars() if v.persistable
             and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}
        want = [np.asarray(o).ravel()[0] for _ in range(TRAIN_STEPS)
                for o in exe.run(jm, feed=feed, fetch_list=[jloss, jlr])]
    tm, _ts, tloss, tlr = lars_resnet(tfw, tlayers, topt, tres, tun)
    assert tm.to_dict() == jm.to_dict()
    assert sum(op.type == "lars_momentum" for op in tm.global_block().ops) \
        == len(tm.global_block().all_parameters())
    texe = Executor(tfw.CPUPlace())
    tscope = scope_from_numpy(Scope(), init, "cpu", program=tm)
    got = [o.ravel()[0] for _ in range(TRAIN_STEPS)
           for o in texe.run(tm, feed=feed, fetch_list=[tloss, tlr],
                             scope=tscope)]
    np.testing.assert_allclose(got[0::2], want[0::2], atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got[1::2], want[1::2], rtol=LR_RTOL)
    assert list(np.round(got[1::2], 6)) == [2.0, 2.0, 1.0, 1.0, 0.5]
    assert got[-2] < got[0]
