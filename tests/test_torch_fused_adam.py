"""Fused Adam in the PyTorch port (paddle_tpu_torch/kernels/fused_adam.py,
ops/optimizer_ops.py, ir.py) held against the JAX package on the CPU,
over 3 steps of a group of 5 odd-sized members whose beta pows have
diverged (each member keeps its own bias correction).

* The port's plain fused Adam against the reference's ``fused_adam`` op
  lowering (one jnp operation at a time): moments and beta pows BITWISE
  equal; parameters within 2 ulps of each member's scale, because
  XLA:CPU's f32 sqrt is not correctly rounded (on 1e5 random inputs 645
  of its results differ by one ulp from the IEEE square root that
  PyTorch computes), which can move the last bit of p.
* Against the reference's Pallas kernel ``fused_adam_step`` in interpret
  mode (``PADDLE_PALLAS_INTERPRET=1``): beta pows bitwise, moments and
  parameters within 4 ulps of each member's scale: the interpreter jits
  the kernel body, and XLA contracts b1 * m1 + (1 - b1) * g into FMAs,
  which skip a rounding of each product, and a step starts from the last
  step's difference (measured: up to 2.9 ulps after 3 steps).
  (On the card the CUDA kernel is bitwise equal to the plain version:
  chip_smoke.py holds it so.)
* Through the Executor, the fused program and the unfused one take the
  same first step within the same 2 ulps (the unfused ``adam`` op
  divides lr_t * m1 by the denominator, the fused one multiplies lr_t by
  their quotient, as the reference's two lowerings do; later steps would
  also carry that last-bit difference through the network's gradients).
* The CUDA branch builds or raises and never falls back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import optimizer_ops as jopt
from paddle_tpu.pallas_kernels import fused_opt
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import Executor, Scope, scope_to_numpy
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_adam as tfad
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.utils import unique_name as tun

SHAPES = [(37, 5), (1000,), (3, 3, 3), (129,), (2048, 17)]
STEPS = 3
ULPS = 2
ULPS_FMA = 4
EPS32 = float(np.finfo(np.float32).eps)


def _group(seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    params = [rng.randn(*s).astype(f) for s in SHAPES]
    m1 = [(rng.randn(*s) * 1e-3).astype(f) for s in SHAPES]
    m2 = [(rng.rand(*s) * 1e-6).astype(f) for s in SHAPES]
    b1 = [np.array([0.9 ** (1 + i % 3)], f) for i in range(len(SHAPES))]
    b2 = [np.array([0.999 ** (1 + i % 4)], f) for i in range(len(SHAPES))]
    grads = [[(rng.randn(*s) * 1e-3).astype(f) for s in SHAPES]
             for _ in range(STEPS)]
    return params, m1, m2, b1, b2, grads, np.array([1e-3], f)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, what, ulps=ULPS):
    """Within ``ulps`` ulps of each member's largest value."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        tol = ulps * EPS32 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol, (what, i)


def _port_steps(params, m1, m2, b1, b2, grads, lr):
    p, a, b, c, d = _t(params), _t(m1), _t(m2), _t(b1), _t(b2)
    for g in grads:
        p, a, b, c, d, _bf = tfad.fused_adam_step(
            p, _t(g), a, b, torch.from_numpy(lr), c, d)
    return [[x.numpy() for x in xs] for xs in (p, a, b, c, d)]


def _jax_steps(step, params, m1, m2, b1, b2, grads, lr):
    state = (params, m1, m2, b1, b2)
    for g in grads:
        out = step(state[0], g, state[1], state[2], jnp.asarray(lr),
                   state[3], state[4])
        state = out[:5]
    return [[np.asarray(x) for x in xs] for xs in state]


def test_matches_fused_adam_lowering():
    grp = _group()
    want = _jax_steps(lambda *a: jopt.fused_adam(None, *a), *grp)
    got = _port_steps(*grp)
    for name, g, w in zip(("param", "moment1", "moment2", "beta1_pow",
                           "beta2_pow"), got, want):
        if name == "param":
            _close(g, w, name)
        else:
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi, wi, err_msg=name)


def test_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    grp = _group(1)
    want = _jax_steps(fused_opt.fused_adam_step, *grp)
    got = _port_steps(*grp)
    for name, g, w in zip(("param", "moment1", "moment2"), got, want):
        _close(g, w, name, ULPS_FMA)
    for g, w in zip(got[3:], want[3:]):
        for gi, wi in zip(g, w):
            np.testing.assert_array_equal(gi, wi)


def test_bf16_copy_is_the_new_params_cast():
    params, m1, m2, b1, b2, grads, lr = _group(2)
    out = tfad.fused_adam_step(_t(params), _t(grads[0]), _t(m1), _t(m2),
                               torch.from_numpy(lr), _t(b1), _t(b2),
                               bf16_out=True)
    for p, bf in zip(out[0], out[5]):
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf, p.to(torch.bfloat16))


def test_unfused_adam_op_matches_reference():
    params, m1, m2, b1, b2, grads, lr = _group(3)
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.lowering import LowerCtx

    adam = treg.get_op_def("adam").lower
    for i in range(len(SHAPES)):
        want = jopt.adam(None, params[i], grads[0][i], m1[i], m2[i],
                         jnp.asarray(lr), b1[i], b2[i], None, None)
        got = adam(LowerCtx(torch.device("cpu")), *_t(
            [params[i], grads[0][i], m1[i], m2[i], lr, b1[i], b2[i]]),
            None, None)
        _close([got[0].numpy()], [want[0]], "param")
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _train_mnist(monkeypatch, fuse):
    if not fuse:
        monkeypatch.setattr(Executor, "_maybe_fuse_optimizers",
                            lambda self, *a: None)
    main, startup = tfw.Program(), tfw.Program()
    startup.random_seed = 5
    with tun.guard(), tfw.program_guard(main, startup):
        _img, _label, _logits, loss, _acc = tmnist.build_mlp(
            img_shape=(20,), num_classes=5)
        topt.Adam(learning_rate=1e-2).minimize(loss)
    exe, scope = Executor(tfw.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(16, 20).astype(np.float32),
            "label": rng.randint(0, 5, (16, 1)).astype(np.int64)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    types = {op.type for op in main.global_block().ops}
    return scope_to_numpy(scope, main), types


def test_fused_and_unfused_programs_take_the_same_step(monkeypatch):
    fused, fused_types = _train_mnist(monkeypatch, True)
    unfused, unfused_types = _train_mnist(monkeypatch, False)
    assert "fused_adam" in fused_types and "adam" not in fused_types
    assert "adam" in unfused_types and "fused_adam" not in unfused_types
    assert sorted(fused) == sorted(unfused)
    for name in fused:
        _close([fused[name]], [unfused[name]], name)


def _meta_group():
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    return ([m(3, 4)], [m(3, 4)], [m(3, 4)], [m(3, 4)], m(1), [m(1)],
            [m(1)])


def test_cuda_branch_propagates_build_failure(monkeypatch):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    before = tfad.fused_adam_step.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfad._fused_adam_cuda(*_meta_group(), 0.9, 0.999, 1e-8, None)
    assert tfad.fused_adam_step.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        fused_adam_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfad._fused_adam_cuda(*_meta_group(), 0.9, 0.999, 1e-8, None)


def test_cpu_tensors_take_the_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("CPU tensors must not build %s" % name)

    monkeypatch.setattr(_build, "load", no_build)
    params, m1, m2, b1, b2, grads, lr = _group(4)
    before = tfad.fused_adam_step.launches
    tfad.fused_adam_step(_t(params), _t(grads[0]), _t(m1), _t(m2),
                         torch.from_numpy(lr), _t(b1), _t(b2))
    assert tfad.fused_adam_step.launches == before


def test_kernel_source_names_what_it_replaces_and_its_bound():
    src = (_build.CSRC / "fused_adam.cu").read_text()
    assert "fused_opt.py `_adam_kernel`" in src and "Bound:" in src
    assert "__fmul_rn" in src   # no FMA contraction: bitwise to plain
    assert "fused_adam" in _build.SOURCES
