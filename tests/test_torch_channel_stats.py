"""The channel statistics in the PyTorch port
(paddle_tpu_torch/kernels/channel_stats.py, rows 16 and 17) held against
the Pallas kernels of ``tools/bench_reduce_pallas.py`` on the CPU, run in
interpret mode (``pl.pallas_call`` patched with ``interpret=True`` for
the test; the tool itself is not edited), at [1024, 64] and [512, 256]
bf16.

* Row 16: the column sum and sum of squares of x + c within 1e-6 of the
  sum of the terms' magnitudes (both f32, other summation orders).
* Row 17: y = x a + b bitwise (one rounded product and sum, then the
  bf16 rounding, in both), its column sums as row 16's; the tool's
  chained ``pallas_affine_stats`` at one pass gives the same y and the
  same total of the sums.
* The CUDA branch builds or raises and never falls back."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import channel_stats as tcs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1024, 64), (512, 256)]
BLOCK_R = 256
RTOL = 1e-6


@pytest.fixture
def tool(monkeypatch):
    """tools/bench_reduce_pallas.py with its pallas_call in interpret
    mode."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(
        "bench_reduce_pallas", os.path.join(ROOT, "tools",
                                            "bench_reduce_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(
        mod.pl.pallas_call, interpret=True))
    return mod


def _inputs(m, c, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, c).astype(np.float32)) \
        .to(torch.bfloat16)
    a = torch.from_numpy((1.0 + 0.1 * rng.randn(1, c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(1, c)).astype(np.float32))
    cv = torch.full((1, 1), 0.25)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return x, a, b, cv, jx


def _close(got, want, terms):
    """|got - want| within RTOL of the sum of the terms' magnitudes."""
    np.testing.assert_allclose(np.asarray(got).reshape(-1),
                               np.asarray(want).reshape(-1), rtol=0,
                               atol=RTOL * float(np.abs(terms).sum(0).max()))


@pytest.mark.parametrize("m, c", SHAPES)
def test_stats_matches_tool_kernel(tool, m, c):
    x, _a, _b, cv, jx = _inputs(m, c)
    js, jss = tool.pallas_stats_one(jx, jnp.asarray(cv.numpy()), BLOCK_R)
    s, ss = tcs.stats(x, cv)   # a CPU tensor: the plain version
    xf = x.float().numpy() + 0.25
    _close(s, js, xf)
    _close(ss, jss, xf * xf)


def _affine_call(tool, x, a, b):
    """The tool's ``_affine_stats_kernel`` through the tool's
    pallas_call layout, one pass -> (y, s, ss)."""
    m, ch = x.shape
    pl = tool.pl
    return pl.pallas_call(
        tool._affine_stats_kernel, grid=(m // BLOCK_R,),
        in_specs=[pl.BlockSpec((BLOCK_R, ch), lambda i: (i, 0)),
                  pl.BlockSpec((1, ch), lambda i: (0, 0)),
                  pl.BlockSpec((1, ch), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((BLOCK_R, ch), lambda i: (i, 0)),
                   pl.BlockSpec((1, ch), lambda i: (0, 0)),
                   pl.BlockSpec((1, ch), lambda i: (0, 0))],
        out_shape=[tool.jax.ShapeDtypeStruct((m, ch), x.dtype),
                   tool.jax.ShapeDtypeStruct((1, ch), jnp.float32),
                   tool.jax.ShapeDtypeStruct((1, ch), jnp.float32)],
    )(x, a, b)


@pytest.mark.parametrize("m, c", SHAPES)
def test_affine_stats_matches_tool_kernel(tool, monkeypatch, m, c):
    x, a, b, _cv, jx = _inputs(m, c, seed=1)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    jy, js, jss = _affine_call(tool, jx, ja, jb)
    y, s, ss = tcs.affine_stats(x, a, b)
    np.testing.assert_array_equal(
        y.float().numpy(), np.asarray(jy.astype(jnp.float32)))
    yf = x.float().numpy() * a.numpy() + b.numpy()
    _close(s, js, yf)
    _close(ss, jss, yf * yf)
    # the tool's own chained function at one pass
    monkeypatch.setattr(tool, "REP", 1)
    total, jy1 = tool.pallas_affine_stats(jx, ja, jb, BLOCK_R)
    np.testing.assert_array_equal(np.asarray(jy1), np.asarray(jy))
    np.testing.assert_allclose(float(total), float(s.sum() + ss.sum()),
                               rtol=RTOL)


# -- the CUDA branch

def _meta(m=64, c=64):
    return torch.empty(m, c, dtype=torch.bfloat16, device="meta")


def _meta_args():
    f32 = dict(dtype=torch.float32, device="meta")
    return {"stats": (tcs._stats_cuda, (_meta(), torch.empty(1, 1, **f32))),
            "affine_stats": (tcs._affine_stats_cuda,
                             (_meta(), torch.empty(1, 64, **f32),
                              torch.empty(1, 64, **f32)))}


@pytest.mark.parametrize("which", ["stats", "affine_stats"])
def test_cuda_branch_propagates_build_failure(monkeypatch, which):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    fn, args = _meta_args()[which]
    before = getattr(tcs, which).launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn(*args)
    assert getattr(tcs, which).launches == before


@pytest.mark.parametrize("which", ["stats", "affine_stats"])
def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch, which):
    class _Lib:
        channel_stats_bf16 = staticmethod(lambda *a: 0)
        affine_stats_bf16 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    fn, args = _meta_args()[which]
    with pytest.raises(ValueError, match="not a CUDA device"):
        fn(*args)
    with pytest.raises(ValueError, match="C % 8 == 0"):
        fn(_meta(64, 12), *args[1:])


def test_plain_versions_on_meta_and_shapes():
    s, ss = tcs.stats(_meta(), torch.empty(1, 1, device="meta"))
    assert tuple(s.shape) == tuple(ss.shape) == (64,)
    y, s, ss = tcs.affine_stats(_meta(8, 16), torch.empty(1, 16,
                                                          device="meta"),
                                torch.empty(1, 16, device="meta"))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (8, 16)
