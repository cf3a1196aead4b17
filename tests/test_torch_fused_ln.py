"""Fused dropout-add-LayerNorm and LayerNorm in the PyTorch port
(paddle_tpu_torch/kernels/fused_ln.py, layer_norm.py) held against the
JAX reference on the CPU.

* The port's ``fused_ln_fwd`` (its plain version on CPU tensors) gives
  the reference ``fused_ln.fused_ln_fwd``'s z, r, mean and var at
  dropout probability 0 (the jnp fallback on the CPU), atol 1e-5 (f32),
  and at p = 0.1 with the reference's ``_fallback_keep`` patched to the
  port's Philox mask (the two packages' streams differ), same atol.
* The port's ``layer_norm_2d``, and the port's ``layer_norm`` op run by
  its own Executor, give what the reference's ``layer_norm`` op gives
  through a JAX CPU Executor (its jnp branch), atol 1e-5.
* The fused_dropout_add_ln op at p = 0.1 in a training program, run by
  the port's Executor, gives the reference op's output from the same
  mask (keyed by the Seed the port's op emits), atol 1e-5.
* The CUDA branches build or raise and never fall back.
* The forward kernel's float4 draw (one Philox group a run of four
  columns, emulated as in tests/test_torch_fused_ln_bwd.py) is bit for
  bit ``philox.keep_mask``, and the r it forms (the kept y rounded after
  its product, then added) is the plain version's r, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.pallas_kernels import fused_ln as jfl
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.kernels import _build, philox
from paddle_tpu_torch.kernels import fused_ln as tfl
from paddle_tpu_torch.kernels import layer_norm as tln
from test_torch_fused_ln_bwd import _float4_keep

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("shape,axis", [((64, 768), 1), ((8, 16, 64), 2),
                                        ((8, 16, 64), 1)])
def test_fused_ln_matches_reference_at_p0(shape, axis):
    rng = np.random.RandomState(0)
    x = _rand(rng, *shape, scale=2.0, shift=0.5)
    y = _rand(rng, *shape)
    h = int(np.prod(shape[axis:]))
    g, b = _rand(rng, h, shift=1.0), _rand(rng, h)
    want = jfl.fused_ln_fwd(x, y, g, b, 0.0, np.zeros(2, np.uint32), 1e-5,
                            axis)
    got = tfl.fused_ln_fwd(*(torch.from_numpy(a) for a in (x, y, g, b)),
                           0.0, None, 1e-5, axis)
    for name, gv, wv in zip(("z", "r", "mean", "var"), got, want):
        assert gv.dtype == torch.float32, name
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL,
                                   rtol=0, err_msg=name)


def _patch_reference_keep(monkeypatch, words):
    """The reference's jnp keep draw returns the port's mask for the
    stream keyed by ``words``."""
    monkeypatch.setattr(
        jfl, "_fallback_keep",
        lambda seed, thr, shape: jnp.asarray(
            philox.keep_mask(words, thr, shape).numpy()))


def test_fused_ln_dropout_raises(monkeypatch):
    """Dropout at p = 0.1, once a raise: z, r, mean and var equal the
    reference's from the same keep mask, and the mask is in effect."""
    rng = np.random.RandomState(3)
    x, y = _rand(rng, 8, 16, 64, scale=2.0), _rand(rng, 8, 16, 64)
    g, b = _rand(rng, 64, shift=1.0), _rand(rng, 64)
    words = (0xC0FFEE, 42)
    _patch_reference_keep(monkeypatch, words)
    want = jfl.fused_ln_fwd(x, y, g, b, 0.1, np.asarray(words, np.uint32),
                            1e-5, 2)
    seed_out = torch.empty(2, dtype=torch.int32)
    got = tfl.fused_ln_fwd(*(torch.from_numpy(a) for a in (x, y, g, b)),
                           0.1, words, 1e-5, 2, seed_out=seed_out)
    assert philox.seed_words(seed_out) == words
    for name, gv, wv in zip(("z", "r", "mean", "var"), got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL,
                                   rtol=0, err_msg=name)
    p0 = tfl.fused_ln_fwd(*(torch.from_numpy(a) for a in (x, y, g, b)),
                          0.0, None, 1e-5, 2)
    assert float((p0[1] - got[1]).abs().max()) > 0.1


def _jax_layer_norm(x, g, b, eps):
    """The reference's layer_norm op on a JAX CPU Executor."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", shape=[x.shape[1]])
        yv = fluid.layers.layer_norm(xv, begin_norm_axis=1, epsilon=eps)
    op = main.global_block().ops[-1]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        scope.var(op.input("Scale")[0]).set(g)
        scope.var(op.input("Bias")[0]).set(b)
        return exe.run(main, feed={"x": x},
                       fetch_list=[yv, op.output("Mean")[0],
                                   op.output("Variance")[0]])


@pytest.mark.parametrize("rows,cols", [(12, 64), (37, 200), (5, 768)])
def test_layer_norm_2d_matches_reference_op(rows, cols):
    rng = np.random.RandomState(1)
    x = _rand(rng, rows, cols, scale=3.0, shift=-1.0)
    g, b = _rand(rng, cols, shift=1.0), _rand(rng, cols)
    want = _jax_layer_norm(x, g, b, 1e-5)
    got = tln.layer_norm_2d(*(torch.from_numpy(a) for a in (x, g, b)),
                            1e-5)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), wv, atol=ATOL, rtol=0)


def test_port_layer_norm_op_matches_reference_op():
    """The port's layer_norm op (ops/nn.py), through its own Executor on
    the CPU, with the same parameters handed over as numpy."""
    rng = np.random.RandomState(2)
    x = _rand(rng, 6, 48, scale=2.0)
    g, b = _rand(rng, 48, shift=1.0), _rand(rng, 48)
    want = _jax_layer_norm(x, g, b, 1e-5)
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        xv = tlayers.data("x", shape=[48])
        yv = tlayers.layer_norm(xv, begin_norm_axis=1)
    op = main.global_block().ops[-1]
    scope = scope_from_numpy(Scope(), {op.input("Scale")[0]: g,
                                       op.input("Bias")[0]: b}, "cpu")
    got = Executor(tfw.CPUPlace()).run(
        main, feed={"x": x}, scope=scope,
        fetch_list=[yv, op.output("Mean")[0], op.output("Variance")[0]])
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv, wv, atol=ATOL, rtol=0)


def test_fused_op_in_training_mode_raises(monkeypatch):
    """The op in training mode (p = 0.1), once a raise: run by the port's
    Executor, its output equals the reference op's lowering on the same
    inputs and mask; the Seed it emits holds the key words of the port's
    per-op seed, and a second step draws another mask."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[4, 8])
        y = tlayers.data("y", shape=[4, 8])
        out = tlayers.fused_dropout_add_ln(x, y, dropout_prob=0.1,
                                           begin_norm_axis=2)
    # shape inference ran (meta tensors): the op's shapes are known
    assert main.global_block().var(out.name).shape == (-1, 4, 8)
    op = main.global_block().ops[-1]
    exe = Executor("cpu")
    scope = Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(4)
    feed = {"x": _rand(rng, 2, 4, 8), "y": _rand(rng, 2, 4, 8, scale=3.0)}
    names = [out.name, op.output("Seed")[0], op.input("Scale")[0],
             op.input("Bias")[0]]
    got, seed, g, b = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    got2, seed2 = exe.run(main, feed=feed, fetch_list=names[:2], scope=scope)
    assert seed.dtype == np.int32 and not np.array_equal(seed, seed2)
    assert float(np.abs(got - got2).max()) > 1e-3
    words = philox.seed_words(torch.from_numpy(seed))
    _patch_reference_keep(monkeypatch, words)
    attrs = {k: op.attrs[k] for k in ("dropout_prob", "is_test", "epsilon",
                                      "begin_norm_axis", "fix_seed", "seed")}
    want = jreg.get_op_def("fused_dropout_add_ln").lower(
        JCtx(rng_key=jax.random.key(0), mode="eager"),
        *(jnp.asarray(a) for a in (feed["x"], feed["y"], g, b)), **attrs)[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mod,cuda_fn,args", [
    (tfl, "_fused_ln_cuda", lambda t: (t(4, 8), t(4, 8), t(8), t(8),
                                       1e-5)),
    (tln, "_layer_norm_cuda", lambda t: (t(4, 8), t(8), t(8), 1e-5)),
])
def test_cuda_branch_builds_or_raises(monkeypatch, mod, cuda_fn, args):
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        getattr(mod, cuda_fn)(*args(meta))

    class _Lib:
        fused_ln_fwd_f32 = layer_norm_fwd_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    with pytest.raises(ValueError, match="not a CUDA device"):
        getattr(mod, cuda_fn)(*args(meta))


def test_kernel_sources_name_what_they_replace_and_their_bound():
    for name, replaces in (("fused_ln", "fused_ln.py `_fwd_kernel`"),
                           ("layer_norm", "layer_norm.py `_ln_fwd_kernel`")):
        src = (_build.CSRC / (name + ".cu")).read_text()
        assert replaces in src and "Bound:" in src
        assert name in _build.SOURCES


@pytest.mark.parametrize("h", [768, 1024])
def test_forward_float4_draw_is_the_stream(h):
    """At p = 0.1, h = 768 (six runs a lane) and 1024 (eight), rows from 0
    and from an odd row: the forward's draw of one group a run equals
    ``philox.keep_mask``, so its r equals the plain version's bitwise and
    the backward's float4 kernel re-draws the same mask."""
    words, thr = (0xBEEF, 0x1234), philox.keep_threshold(0.1)
    rng = np.random.RandomState(h)
    rows = 41
    keep = _float4_keep(words, thr, 0, rows, h)
    assert torch.equal(keep, philox.keep_mask(words, thr, (rows, h)))
    assert torch.equal(_float4_keep(words, thr, 37, 4, h), keep[37:])
    x, y = (torch.from_numpy(_rand(rng, rows, h)) for _ in range(2))
    g, b = torch.ones(h), torch.zeros(h)
    inv_q = philox.inv_realized_q(thr)
    r = x + torch.where(keep, y * inv_q, torch.zeros(()))
    _z, want, _m, _v = tfl.fused_ln_reference(x, y, g, b, 1e-5, 0.1, words)
    assert torch.equal(r, want)
