"""The update rules of the PyTorch port held against the JAX package on
the CPU.

* Ops: each update op the port adds (``adagrad``, ``adamax``,
  ``decayed_adagrad``, ``adadelta``, ``rmsprop`` plain, centered and
  with momentum, ``lars_momentum``, ``lamb`` with and without its weight
  decay and at a zero parameter, ``ftrl`` at lr_power -0.5 and -0.6), one
  application to numpy-seeded inputs: every output within OP_ULPS f32
  ulps of its tensor's largest value (XLA:CPU's sqrt is not correctly
  rounded: on random inputs one result in ~150 is one ulp off the IEEE
  root, and a quotient or a norm carries that on), and every output
  written into its input tensor (the scope's), as the reference's
  executor stores it.
* Programs: the MNIST MLP (BASELINE config 1, ``models/mnist.py``
  ``build_mlp``) under each optimizer, regularizer, per-parameter
  learning rate and averaging wrapper of ``CASES``: the port's main and
  startup programs equal the reference's through ``to_dict()`` (op
  types, slots, attrs, roles, variable names and shapes).
* Training (``TRAIN_CASES``): the reference takes 5 steps on 5 batches
  of 64; the port
  takes each step from the reference's state before it, carried with
  ``scope_from_numpy`` (each step from one state: in chained steps two
  f32 summation orders part by up to 4% of a tensor within three steps,
  where a sign-like update puts a relu input at 0 and flips it).  The
  losses agree to LOSS_ATOL; every persistable after each step
  (parameters, accumulators, beta pows, EMA, average and slow buffers,
  the learning rate) is finite and within STATE_RTOL of its tensor's
  largest value, but for at most FLIP_SHARE of its elements: the first
  step of Adam, Adamax, DecayedAdagrad and Ftrl divides by about |g|, so
  a weight whose gradient is a sum that cancels to rounding noise moves
  by a whole step on that noise's sign (measured: at most 1e-4 of a
  tensor, Ftrl; 3.8e-5, DecayedAdagrad; one weight, Adam and Adamax;
  every other element within 7.6e-6).  Where the case has one, the
  wrapper's ``apply`` swaps in the same averages in both and its exit
  restores the parameters.
* The Adam group splits where a parameter's learning rate differs: the
  fusion pass leaves that member's ``adam`` alone and fuses the rest,
  as the reference's pass does.
* The four wrappers still to come raise by name; the initialisers write
  the reference's startup ops, NumpyArray and Bilinear exactly, and the
  random ones draw from the stated distributions.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.core import registry as treg_ops
from paddle_tpu_torch.core import scope_guard as tscope_guard
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.utils import unique_name as tun

EPS32 = float(np.finfo(np.float32).eps)
OP_ULPS = 4
STEPS = 5
BATCH = 64
LOSS_ATOL = 1e-5
STATE_RTOL = 1e-4
FLIP_SHARE = 1e-3

J = types.SimpleNamespace(fw=fluid, layers=fluid.layers, opt=fluid.optimizer,
                          reg=fluid.regularizer, clip=fluid.clip,
                          init=fluid.initializer, ParamAttr=fluid.ParamAttr,
                          un=jun, mlp=jmnist.build_mlp)
T = types.SimpleNamespace(fw=tfw, layers=tlayers, opt=topt, reg=treg,
                          clip=tclip, init=tinit, ParamAttr=TParamAttr,
                          un=tun, mlp=tmnist.build_mlp)


# -- ops -------------------------------------------------------------------


def _op_cases():
    rng = np.random.RandomState(0)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    def pos(*shape):
        return (rng.rand(*shape) + 0.1).astype(np.float32)

    p, g, lr = r(8, 16), r(8, 16), np.array([0.01], np.float32)
    pows = [np.array([0.9 ** 3], np.float32), np.array([0.999 ** 3],
                                                        np.float32)]
    return [
        ("adagrad", [p, g, pos(8, 16), lr], {"epsilon": 1e-6}),
        ("adamax", [p, g, r(8, 16), pos(8, 16), lr, pows[0]],
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        ("decayed_adagrad", [p, g, pos(8, 16), lr],
         {"decay": 0.95, "epsilon": 1e-6}),
        ("adadelta", [p, g, pos(8, 16), pos(8, 16)],
         {"rho": 0.95, "epsilon": 1e-6}),
        ("rmsprop", [p, g, pos(8, 16), r(8, 16) * 0.1, r(8, 16), lr],
         {"decay": 0.9, "momentum": 0.0, "epsilon": 1e-6,
          "centered": False}),
        ("rmsprop", [p, g, pos(8, 16) + 1, r(8, 16) * 0.1, r(8, 16), lr],
         {"decay": 0.9, "momentum": 0.9, "epsilon": 1e-6,
          "centered": True}),
        ("lars_momentum", [p, g, r(8, 16), lr],
         {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 5e-4}),
        ("lamb", [p, g, r(8, 16), pos(8, 16), lr] + pows,
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
          "weight_decay": 0.01}),
        ("lamb", [np.zeros((8, 16), np.float32), g, r(8, 16), pos(8, 16),
                  lr] + pows,
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
          "weight_decay": 0.0}),
        ("ftrl", [p, pos(8, 16), r(8, 16), g, lr],
         {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
        ("ftrl", [p, pos(8, 16), r(8, 16), g, lr],
         {"l1": 0.1, "l2": 0.01, "lr_power": -0.6}),
    ]


OP_CASES = _op_cases()
# the input slot an output slot writes back, where it is not the output's
# name less "Out"
_IN_SLOT = {"SquaredAccumOut": "SquaredAccumulator",
            "LinearAccumOut": "LinearAccumulator"}


@pytest.mark.parametrize("case", range(len(OP_CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_update_op_matches_reference(case):
    op_type, args, attrs = OP_CASES[case]
    want = jreg.get_op_def(op_type).lower(
        JCtx(mode="eager"), *[jnp.asarray(a) for a in args], **attrs)
    ins = [torch.from_numpy(a.copy()) for a in args]
    got = treg_ops.get_op_def(op_type).lower(TCtx(torch.device("cpu")),
                                             *ins, **attrs)
    opdef = treg_ops.get_op_def(op_type)
    ins_by_slot = dict(zip(opdef.input_slots, ins))
    assert len(got) == len(want)
    for slot, g, w in zip(opdef.output_slots, got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        gap = float(np.abs(g.numpy() - w).max())
        assert gap <= OP_ULPS * EPS32 * scale, (op_type, slot, gap / scale)
        state = ins_by_slot[_IN_SLOT.get(slot, slot[:-3])]
        assert g is state, "%s %s is not written in place" % (op_type, slot)


# -- programs and training ----------------------------------------------------


def _excluded(p):
    return p.name.endswith(".b_0")


def _lr_half(main):
    """The second layer's weight takes half the learning rate."""
    main.global_block().var("fc_1.w_0").optimize_attr["learning_rate"] = 0.5


CASES = {
    "adagrad": lambda m: m.opt.Adagrad(0.1, initial_accumulator_value=0.1),
    "adamax": lambda m: m.opt.Adamax(0.002),
    "decayed_adagrad": lambda m: m.opt.DecayedAdagrad(0.005),
    "adadelta": lambda m: m.opt.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda m: m.opt.RMSProp(0.001),
    "rmsprop_centered": lambda m: m.opt.RMSProp(0.001, centered=True),
    "rmsprop_momentum": lambda m: m.opt.RMSProp(0.001, momentum=0.9),
    "rmsprop_centered_momentum": lambda m: m.opt.RMSProp(
        0.001, centered=True, momentum=0.9),
    "ftrl": lambda m: m.opt.Ftrl(0.01, l1=1e-4, l2=1e-3),
    "ftrl_power": lambda m: m.opt.Ftrl(0.01, l1=1e-4, lr_power=-0.6),
    "lamb": lambda m: m.opt.Lamb(
        0.01, lamb_weight_decay=0.01, exclude_from_weight_decay_fn=_excluded),
    "lars": lambda m: m.opt.LarsMomentum(2.0, momentum=0.9),
    "momentum_nesterov": lambda m: m.opt.Momentum(0.01, 0.9,
                                                  use_nesterov=True),
    "sgd_l1": lambda m: m.opt.SGD(0.05, regularization=m.reg.L1Decay(1e-3)),
    "sgd_param_lr": lambda m: m.opt.SGD(0.05),
    "sgd_l1_param_lr": lambda m: m.opt.SGD(
        0.05, regularization=m.reg.L1Decay(1e-3)),
    "adam_param_lr": lambda m: m.opt.Adam(0.002),
    "ema": lambda m: m.opt.Momentum(0.01, 0.9),
    "model_average": lambda m: m.opt.SGD(0.05),
    # an inner rule that updates in place: the startup's slow copy must
    # not alias the parameter
    "lookahead": lambda m: m.opt.LookaheadOptimizer(
        m.opt.Adagrad(0.1, initial_accumulator_value=0.1), alpha=0.5, k=5),
}
# the cases trained against the reference: every class and wrapper once,
# the rmsprop variants and the SGD options together (the op tests hold
# each branch of each rule)
TRAIN_CASES = ("adagrad", "adamax", "decayed_adagrad", "adadelta", "rmsprop",
               "rmsprop_centered_momentum", "ftrl", "lamb", "lars",
               "sgd_l1_param_lr", "adam_param_lr", "ema", "model_average",
               "lookahead")


def build(m, case):
    """(main, startup, loss, wrapper or None) of the MLP under ``case``."""
    main, startup = m.fw.Program(), m.fw.Program()
    startup.random_seed = 5
    wrapper = None
    with m.un.guard(), m.fw.program_guard(main, startup):
        loss = m.mlp()[3]
        if case.endswith("param_lr"):
            _lr_half(main)
        CASES[case](m).minimize(loss)
        if case == "ema":
            wrapper = m.opt.ExponentialMovingAverage(0.9)
            wrapper.update()
        elif case == "model_average":
            wrapper = m.opt.ModelAverage(0.15)
    return main, startup, loss, wrapper


@pytest.mark.parametrize("case", sorted(CASES))
def test_programs_equal_reference(case):
    jm, js, _, _ = build(J, case)
    tm, ts, _, _ = build(T, case)
    assert [op.type for op in tm.global_block().ops] \
        == [op.type for op in jm.global_block().ops]
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def feeds():
    rng = np.random.RandomState(0)
    centres = rng.randn(10, 784).astype(np.float32)
    out = []
    for _ in range(STEPS):
        label = rng.randint(0, 10, (BATCH, 1)).astype(np.int64)
        img = (centres[label.ravel()]
               + rng.randn(BATCH, 784)).astype(np.float32)
        out.append({"img": img, "label": label})
    return out


def _persistables(main):
    return [v.name for v in main.list_vars()
            if v.persistable and not v.is_data]


def _params(main):
    return [p.name for p in main.global_block().all_parameters()]


def jax_train(case):
    """The reference's run: (the persistables before each step and after
    the last, the losses, params inside the wrapper's apply, params after
    it)."""
    main, startup, loss, wrapper = build(J, case)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()

    def state(names):
        return {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}

    applied = after = None
    with fluid.scope_guard(scope):
        exe.run(startup)
        states, losses = [state(_persistables(main))], []
        for f in feeds():
            losses.append(float(np.asarray(
                exe.run(main, feed=f, fetch_list=[loss])[0]).ravel()[0]))
            states.append(state(_persistables(main)))
        if wrapper is not None:
            with wrapper.apply(exe):
                applied = state(_params(main))
            after = state(_params(main))
    return states, losses, applied, after


def port_train(case, states):
    """Each step of the port from the reference's state before it ->
    (losses, the states after each step, params inside the wrapper's
    apply after the last step, params after it)."""
    main, _startup, loss, wrapper = build(T, case)
    exe = Executor(tfw.CPUPlace())
    losses, after_steps = [], []
    for before, f in zip(states, feeds()):
        scope = scope_from_numpy(Scope(), before, "cpu", program=main)
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0].ravel()[0]))
        after_steps.append({n: scope.find_var(n).get_tensor().numpy()
                            for n in _persistables(main)})
    applied = after = None
    if wrapper is not None:
        with tscope_guard(scope):
            with wrapper.apply(exe):
                applied = {n: scope.find_var(n).get_tensor().numpy()
                           for n in _params(main)}
            after = {n: scope.find_var(n).get_tensor().numpy()
                     for n in _params(main)}
    return losses, after_steps, applied, after


def _gaps(got, want):
    """(largest |got - want| over |want|'s largest, the share of elements
    beyond STATE_RTOL of it)."""
    d = np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)
    return float(d.max()), float((d > STATE_RTOL).mean())


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mlp_trains_as_the_reference(case):
    states, want_losses, want_applied, want_after = jax_train(case)
    kept = [{n: a.copy() for n, a in st.items()} for st in states]
    losses, after_steps, applied, after = port_train(case, states)
    for st, k in zip(states, kept):  # the in-place updates wrote copies
        assert all(np.array_equal(st[n], k[n]) for n in k)
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    assert want_losses[-1] < want_losses[0]
    for step, (got, want) in enumerate(zip(after_steps, states[1:])):
        assert sorted(got) == sorted(want)
        for n in want:
            assert np.isfinite(got[n]).all(), (step, n)
            worst, share = _gaps(got[n], want[n])
            assert worst <= STATE_RTOL or share <= FLIP_SHARE, (
                step, n, worst, share)
    if want_applied is not None:
        final = after_steps[-1]
        for n in want_applied:
            assert _gaps(applied[n], want_applied[n])[0] <= STATE_RTOL, n
            assert not np.allclose(applied[n], final[n]), n  # swapped in
            np.testing.assert_array_equal(after[n], final[n])  # restored


def test_a_per_parameter_learning_rate_splits_the_fused_group():
    jm, _js, _, _ = build(J, "adam_param_lr")
    tm, _ts, _, _ = build(T, "adam_param_lr")
    jir.apply_pass("fuse_optimizer_ops_pass", jm, None)
    tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
    assert tm.to_dict() == jm.to_dict()
    ops = tm.global_block().ops
    fused = [op for op in ops if op.type == "fused_adam"]
    alone = [op for op in ops if op.type == "adam"]
    assert len(fused) == 1 and len(fused[0].input("Param")) == 5
    assert [op.input("Param") for op in alone] == [["fc_1.w_0"]]
    scaled = alone[0].input("LearningRate")[0]
    assert scaled != fused[0].input("LearningRate")[0]
    producer, = [op for op in ops if scaled in op.output_arg_names]
    assert producer.type == "scale" and producer.attr("scale") == 0.5
    assert producer.attr("op_role") == tfw.OpRole.LRSched


def test_ema_restore_puts_the_parameters_back():
    main, startup, loss, ema = build(T, "ema")
    exe, scope = Executor(tfw.CPUPlace()), Scope()
    with tscope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=feeds()[0], fetch_list=[loss])
        before = scope.find_var("fc_0.w_0").get_tensor().numpy()
        with ema.apply(exe, need_restore=False):
            pass
        swapped = scope.find_var("fc_0.w_0").get_tensor().numpy()
        ema.restore(exe)
        np.testing.assert_array_equal(
            scope.find_var("fc_0.w_0").get_tensor().numpy(), before)
    np.testing.assert_array_equal(
        swapped, scope.find_var(ema._ema_vars["fc_0.w_0"].name)
        .get_tensor().numpy())


def test_lookahead_slow_weights_start_as_a_copy():
    """The startup's ``assign`` copies the parameter: with an inner rule
    that updates it in place, slow = p0 + alpha / k (p1 - p0) after a
    step, not the updated parameter."""
    main, startup, loss, _ = build(T, "lookahead")
    exe, scope = Executor(tfw.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    slow = [v.name for v in main.list_vars() if v.name.startswith(
        "fc_0.w_0.slow")][0]
    p0 = scope.find_var("fc_0.w_0").get_tensor().numpy()
    exe.run(main, feed=feeds()[0], fetch_list=[loss], scope=scope)
    p1 = scope.find_var("fc_0.w_0").get_tensor().numpy()
    got = scope.find_var(slow).get_tensor().numpy()
    assert not np.allclose(p1, p0)
    np.testing.assert_allclose(got, p0 + 0.1 * (p1 - p0), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name, item", [
    ("GradientMergeOptimizer", "conditional_block"),
    ("RecomputeOptimizer", "recompute"),
    ("PipelineOptimizer", "parallel"),
    ("DGCMomentumOptimizer", "collectives")])
def test_unported_wrappers_raise_by_name(name, item):
    """The wrappers still to port raise by name; GradientMergeOptimizer,
    ported with the control flow, builds the reference's program: the
    MLP under it at k = 3 over SGD, its update ops in a conditional_block's
    sub-block."""
    if name == "GradientMergeOptimizer":
        progs = []
        for m in (J, T):
            main, startup = m.fw.Program(), m.fw.Program()
            with m.un.guard(), m.fw.program_guard(main, startup):
                getattr(m.opt, name)(m.opt.SGD(0.1), k_steps=3).minimize(
                    m.mlp()[3])
            progs.append((main.to_dict(), startup.to_dict()))
        assert progs[1] == progs[0]
        ops = [op["type"] for op in progs[1][0]["blocks"][0]["ops"]]
        assert item in ops
        assert {op["type"] for op in progs[1][0]["blocks"][1]["ops"]} \
            == {"scale", "sgd", "assign"}
        return
    with pytest.raises(NotImplementedError, match="%s.*%s" % (name, item)):
        getattr(topt, name)(topt.SGD(0.1))


def test_aliases_and_all_match_the_reference():
    assert sorted(topt.__all__) == sorted(set(fluid.optimizer.__all__)
                                          | {"Optimizer"})
    for name in fluid.optimizer.__all__:
        assert hasattr(topt, name), name


# -- initialisers --------------------------------------------------------------

INITS = {
    "truncated_normal": lambda m: m.init.TruncatedNormal(loc=0.5, scale=2.0),
    "msra_uniform": lambda m: m.init.MSRA(),
    "msra_normal": lambda m: m.init.MSRAInitializer(uniform=False),
    "xavier_normal": lambda m: m.init.XavierInitializer(uniform=False),
    "bilinear": lambda m: m.init.Bilinear(),
    "numpy": lambda m: m.init.NumpyArrayInitializer(
        np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(2, 3, 4, 4) / 7),
}


def init_program(m, kind, shape=(2, 3, 4, 4)):
    main, startup = m.fw.Program(), m.fw.Program()
    startup.random_seed = 3
    with m.un.guard(), m.fw.program_guard(main, startup):
        main.global_block().create_parameter(
            name="w", shape=list(shape), dtype="float32")
        w = main.global_block().var("w")
        INITS[kind](m)(w)
    return main, startup


@pytest.mark.parametrize("kind", sorted(INITS))
def test_initialisers_write_the_reference_startup(kind):
    _jm, js = init_program(J, kind)
    _tm, ts = init_program(T, kind)
    assert ts.to_dict() == js.to_dict()


def _draw(kind, shape):
    main, startup = init_program(T, kind, shape)
    scope = Scope()
    Executor(tfw.CPUPlace()).run(startup, scope=scope)
    return scope.find_var("w").get_tensor().numpy()


@pytest.mark.parametrize("kind", ["numpy", "bilinear"])
def test_array_initialisers_are_exact(kind):
    main, startup = init_program(J, kind)
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    want = np.asarray(jscope.find_var("w").get_tensor().numpy())
    np.testing.assert_array_equal(_draw(kind, (2, 3, 4, 4)), want)


def test_random_initialisers_draw_the_stated_distributions():
    shape = (256, 64, 3, 3)               # fan_in 576, fan_out 2304
    n = float(np.prod(shape))
    w = _draw("truncated_normal", shape)   # N(0.5, 2^2) cut at 2 std
    assert w.min() >= 0.5 - 4.0 and w.max() <= 0.5 + 4.0
    assert w.min() < 0.5 - 3.9 and w.max() > 0.5 + 3.9
    # a standard normal cut at +-2 has std 0.8796
    assert abs(w.mean() - 0.5) < 5 * 2.0 * 0.88 / np.sqrt(n)
    assert abs(w.std() / 2.0 - 0.8796) < 5e-3
    std = np.sqrt(2.0 / 576)
    assert abs(_draw("msra_normal", shape).std() / std - 1) < 5e-3
    limit = np.sqrt(6.0 / 576)
    u = _draw("msra_uniform", shape)
    assert u.min() >= -limit and u.max() <= limit
    assert abs(u.std() / (limit / np.sqrt(3)) - 1) < 5e-3
    xstd = np.sqrt(2.0 / (576 + 2304))
    assert abs(_draw("xavier_normal", shape).std() / xstd - 1) < 5e-3
