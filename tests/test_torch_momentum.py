"""Momentum in the PyTorch port (paddle_tpu_torch/kernels/fused_momentum.py,
ops/optimizer_ops.py ``momentum``/``fused_momentum``, optimizer.py
``MomentumOptimizer``, regularizer.py ``L2Decay``, ir.py's momentum group)
held against the JAX package on the CPU, over 3 steps of a group of 5
odd-sized members.

* The port's plain fused momentum against the reference's
  ``fused_momentum`` op lowering (its jnp path), plain and Nesterov:
  parameters and velocities within 2 ulps of each member's largest
  value, the bound the fused-Adam tests state: XLA:CPU may contract
  mu * v + g into an FMA, which skips a rounding, and a step starts from
  the last step's difference.
* Against the reference's Pallas kernel ``fused_momentum_step`` in
  interpret mode: the same bound (4 ulps, as the Adam kernel's), and the
  bf16 copy is the new parameters' cast.
* The unfused ``momentum`` op and the l2_decay attribute (the plain path
  of the fused op) against the reference's lowerings, same bounds.
* Programs: ``Momentum(regularization=L2Decay)`` appends the reference's
  scale + in-place sum ops and momentum ops, and the fusion pass makes
  the reference's ``fused_momentum`` (conv filters, rank 4, stay apart).
* The CUDA branch builds or raises and never falls back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu.ops import optimizer_ops as jopt
from paddle_tpu.pallas_kernels import adoption
from paddle_tpu.pallas_kernels import fused_opt
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg_l2
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_momentum as tfm
from paddle_tpu_torch.utils import unique_name as tun

SHAPES = [(37, 5), (1000,), (3, 3, 3), (129,), (2048, 17)]
STEPS = 3
ULPS = 2
ULPS_FMA = 4
EPS32 = float(np.finfo(np.float32).eps)
MU = 0.9


def _group(seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    params = [rng.randn(*s).astype(f) for s in SHAPES]
    vels = [(rng.randn(*s) * 1e-2).astype(f) for s in SHAPES]
    grads = [[(rng.randn(*s) * 1e-2).astype(f) for s in SHAPES]
             for _ in range(STEPS)]
    return params, vels, grads, np.array([0.1], f)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, what, ulps=ULPS):
    """Within ``ulps`` ulps of each member's largest value."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        tol = ulps * EPS32 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol, (what, i)


def _port_steps(params, vels, grads, lr, nesterov):
    p, v = _t(params), _t(vels)
    for g in grads:
        p, v, _bf = tfm.fused_momentum_step(p, _t(g), v, torch.from_numpy(lr),
                                            MU, nesterov)
    return [x.numpy() for x in p], [x.numpy() for x in v]


def _jax_steps(step, params, vels, grads, lr):
    p, v = params, vels
    for g in grads:
        out = step(p, g, v, jnp.asarray(lr))
        p, v = out[0], out[1]
    return [np.asarray(x) for x in p], [np.asarray(x) for x in v]


@pytest.mark.parametrize("nesterov", [False, True])
def test_matches_fused_momentum_lowering(nesterov):
    grp = _group()
    want = _jax_steps(lambda p, g, v, lr: jopt.fused_momentum(
        None, p, g, v, lr, mu=MU, use_nesterov=nesterov), *grp)
    got = _port_steps(*grp, nesterov)
    for name, g, w in zip(("param", "velocity"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("nesterov", [False, True])
def test_matches_pallas_kernel_in_interpret_mode(monkeypatch, nesterov):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    adoption.reset()
    grp = _group(1)
    want = _jax_steps(lambda p, g, v, lr: fused_opt.fused_momentum_step(
        p, g, v, lr, mu=MU, use_nesterov=nesterov), *grp)
    got = _port_steps(*grp, nesterov)
    for name, g, w in zip(("param", "velocity"), got, want):
        _close(g, w, name, ULPS_FMA)


def test_bf16_copy_is_the_new_params_cast():
    params, vels, grads, lr = _group(2)
    p, _v, bf = tfm.fused_momentum_step(_t(params), _t(grads[0]), _t(vels),
                                        torch.from_numpy(lr), MU,
                                        bf16_out=True)
    for x, b in zip(p, bf):
        assert b.dtype == torch.bfloat16 and torch.equal(
            b, x.to(torch.bfloat16))


@pytest.mark.parametrize("attrs", [
    {"mu": MU}, {"mu": MU, "use_nesterov": True},
    {"mu": MU, "regularization_method": "l2_decay",
     "regularization_coeff": 1e-4},
])
def test_momentum_ops_match_reference(attrs):
    """The unfused op per member, and the fused op's plain l2_decay path
    over the group (the kernel route is taken only without it)."""
    params, vels, grads, lr = _group(3)
    mom = treg.get_op_def("momentum").lower
    ctx = LowerCtx(torch.device("cpu"))
    for i in range(len(SHAPES)):
        want = jopt.momentum(None, params[i], grads[0][i], vels[i],
                             jnp.asarray(lr), **attrs)
        got = mom(ctx, *_t([params[i], grads[0][i], vels[i], lr]), **attrs)
        for name, g, w in zip(("param", "velocity"), got, want):
            _close([g.numpy()], [w], name)
    want = jopt.fused_momentum(None, params, grads[0], vels, jnp.asarray(lr),
                               **attrs)
    got = treg.get_op_def("fused_momentum").lower(
        ctx, _t(params), _t(grads[0]), _t(vels), torch.from_numpy(lr),
        **attrs)
    for name, g, w in zip(("param", "velocity"), got, want):
        _close([x.numpy() for x in g], w, name)


# -- programs 

def _net(L, opt_mod, reg_mod):
    """A small conv + batch-norm + fc net trained by Momentum with L2
    decay: conv filters (rank 4) interleave with the fused group's
    members in the optimizer's name order."""
    img = L.data("img", shape=[3, 8, 8])
    label = L.data("label", shape=[1], dtype="int64")
    x = L.batch_norm(L.conv2d(img, 8, 3, padding=1, bias_attr=False),
                     act="relu")
    x = L.batch_norm(L.conv2d(x, 8, 3, stride=2, padding=1,
                              bias_attr=False), act="relu")
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(x, 4), label))
    opt_mod.Momentum(learning_rate=0.05, momentum=MU,
                     regularization=reg_mod.L2Decay(1e-4)).minimize(loss)
    return loss


def _programs():
    jm, js = fluid.Program(), fluid.Program()
    js.random_seed = 5
    with jun.guard(), fluid.program_guard(jm, js):
        jloss = _net(fluid.layers, fluid.optimizer, fluid.regularizer)
    tm, ts = tfw.Program(), tfw.Program()
    ts.random_seed = 5
    with tun.guard(), tfw.program_guard(tm, ts):
        tloss = _net(tlayers, topt, treg_l2)
    return (jm, js, jloss), (tm, ts, tloss)


@pytest.mark.parametrize("fused", [False, True])
def test_momentum_programs_equal_reference(fused):
    (jm, js, _jl), (tm, ts, _tl) = _programs()
    if fused:
        jir.apply_pass("fuse_optimizer_ops_pass", jm, None)
        tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
        ops = tm.global_block().ops
        assert sum(op.type == "fused_momentum" for op in ops) == 1
        # the two conv filters keep their own momentum ops
        assert sum(op.type == "momentum" for op in ops) == 2
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def test_momentum_training_steps_match_reference():
    """3 steps of the net through both executors from the reference's
    initial state: losses to 1e-5, and every velocity (the L2-decayed
    gradients' running sum) to 1e-4 of its largest value."""
    (jm, js, jloss), (tm, _ts, tloss) = _programs()
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(8, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars()
             if v.persistable and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}
        jl = [float(np.asarray(exe.run(jm, feed=feed,
                                       fetch_list=[jloss])[0]).ravel()[0])
              for _ in range(3)]
        want = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names if "velocity" in n}
    tsc = scope_from_numpy(Scope(), init, "cpu", program=tm)
    texe = Executor(tfw.CPUPlace())
    tl = [float(texe.run(tm, feed=feed, fetch_list=[tloss],
                         scope=tsc)[0].ravel()[0]) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert any(op.type == "fused_momentum" for op in tm.global_block().ops)
    for n, w in want.items():
        got = tsc.find_var(n).get_tensor().numpy()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)


# -- the CUDA branch 

def _meta_group():
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    return [m(3, 4)], [m(3, 4)], [m(3, 4)], m(1)


def test_cuda_branch_propagates_build_failure(monkeypatch):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    before = tfm.fused_momentum_step.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfm._fused_momentum_cuda(*_meta_group(), MU, False, None)
    assert tfm.fused_momentum_step.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        fused_momentum_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfm._fused_momentum_cuda(*_meta_group(), MU, False, None)
