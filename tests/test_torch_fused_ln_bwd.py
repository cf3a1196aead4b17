"""Backward of the fused dropout-add-LayerNorm in the PyTorch port
(paddle_tpu_torch/kernels/fused_ln.py ``fused_ln_bwd``) held against the
JAX reference (paddle_tpu/pallas_kernels/fused_ln.py ``fused_ln_bwd``,
its jnp pass on the CPU) at dropout probability 0 and 0.1.

* dx, dy, dgamma and dbeta from the forward's r, mean and var, on several
  shapes and norm axes: dx and dy to atol 1e-5 (f32, another library's
  summation order), dgamma and dbeta, sums over all rows, to 1e-5 of
  their largest value.
* At dropout 0, dy is dx (one tensor).
* At dropout 0.1, dx, dy, dgamma and dbeta equal the reference's from
  the same keep mask (its ``_fallback_keep`` patched to the port's
  Philox mask), the port's backward re-drawing it from the forward's
  Seed tensor; same tolerances.
* The CUDA branch builds or raises and never falls back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels import fused_ln as jfl
from paddle_tpu_torch.kernels import _build, philox
from paddle_tpu_torch.kernels import fused_ln as tfl

ATOL = 1e-5
SUM_RTOL = 1e-5


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [((64, 768), 1), ((8, 16, 64), 2), ((8, 16, 64), 1),
         ((37, 200), 1), ((3, 5, 7, 9), 3), ((4, 2000), 1)]


@pytest.mark.parametrize("shape,axis", CASES)
def test_matches_reference_backward_at_p0(shape, axis):
    rng = np.random.RandomState(0)
    x, y = _rand(rng, *shape, scale=2.0, shift=0.5), _rand(rng, *shape)
    h = int(np.prod(shape[axis:]))
    g, b = _rand(rng, h, shift=1.0), _rand(rng, h)
    dz = _rand(rng, *shape)
    seed = np.zeros(2, np.uint32)
    _z, r, mean, var = jfl.fused_ln_fwd(x, y, g, b, 0.0, seed, 1e-5, axis)
    want = jfl.fused_ln_bwd(r, g, seed, mean, var, dz, 0.0, 1e-5, axis)
    got = tfl.fused_ln_bwd(_t(r), _t(g), _t(mean), _t(var), _t(dz), 0.0,
                           None, 1e-5, axis)
    for name, gv, wv in zip(("dx", "dy"), got[:2], want[:2]):
        assert gv.shape == tuple(shape)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL,
                                   rtol=0, err_msg=name)
    for name, gv, wv in zip(("dgamma", "dbeta"), got[2:], want[2:]):
        wv = np.asarray(wv)
        assert gv.shape == (h,)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=0,
                                   atol=SUM_RTOL * float(np.abs(wv).max()),
                                   err_msg=name)
    assert got[0] is got[1]


def test_port_forward_then_backward_matches_reference():
    """The port's own forward statistics feed its backward."""
    rng = np.random.RandomState(1)
    x, y, dz = (_rand(rng, 6, 48) for _ in range(3))
    g, b = _rand(rng, 48, shift=1.0), _rand(rng, 48)
    seed = np.zeros(2, np.uint32)
    _z, r, mean, var = tfl.fused_ln_fwd(_t(x), _t(y), _t(g), _t(b))
    got = tfl.fused_ln_bwd(r, _t(g), mean, var, _t(dz))
    _z, jr, jm, jv = jfl.fused_ln_fwd(x, y, g, b, 0.0, seed, 1e-5, 1)
    want = jfl.fused_ln_bwd(jr, g, seed, jm, jv, dz, 0.0, 1e-5, 1)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL,
                                   rtol=0)


def test_dropout_raises(monkeypatch):
    """Dropout at p = 0.1, once a raise: the backward from the port's own
    forward (its r, statistics and Seed) equals the reference's from the
    same mask; dy is the dropped dx, not dx."""
    shape, axis = (8, 16, 64), 2
    rng = np.random.RandomState(2)
    x, y = _rand(rng, *shape, scale=2.0), _rand(rng, *shape)
    h = int(np.prod(shape[axis:]))
    g, b = _rand(rng, h, shift=1.0), _rand(rng, h)
    dz = _rand(rng, *shape)
    words = (0xFACE, 0xB00C)
    monkeypatch.setattr(
        jfl, "_fallback_keep",
        lambda seed, thr, shp: jnp.asarray(
            philox.keep_mask(words, thr, shp).numpy()))
    jseed = np.asarray(words, np.uint32)
    _z, jr, jm, jv = jfl.fused_ln_fwd(x, y, g, b, 0.1, jseed, 1e-5, axis)
    want = jfl.fused_ln_bwd(jr, g, jseed, jm, jv, dz, 0.1, 1e-5, axis)
    seed_t = torch.empty(2, dtype=torch.int32)
    _z, r, mean, var = tfl.fused_ln_fwd(_t(x), _t(y), _t(g), _t(b), 0.1,
                                        words, 1e-5, axis, seed_out=seed_t)
    got = tfl.fused_ln_bwd(r, _t(g), mean, var, _t(dz), 0.1, seed_t, 1e-5,
                           axis)
    for name, gv, wv in zip(("dx", "dy"), got[:2], want[:2]):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL,
                                   rtol=0, err_msg=name)
    for name, gv, wv in zip(("dgamma", "dbeta"), got[2:], want[2:]):
        wv = np.asarray(wv)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=0,
                                   atol=SUM_RTOL * float(np.abs(wv).max()),
                                   err_msg=name)
    assert got[0] is not got[1]
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_backward_grid_covers_every_row():
    for n in (1, 4, 37, 1056, 4096, 100003):
        rows, ctas = tfl._bwd_grid(n)
        assert rows % 4 == 0 and rows * ctas >= n > rows * (ctas - 1)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_cuda_branch_propagates_build_failure(monkeypatch):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    before = tfl.fused_ln_bwd.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfl._fused_ln_bwd_cuda(_meta(4, 8), _meta(8), _meta(4), _meta(4),
                               _meta(4, 8), 1e-5)
    assert tfl.fused_ln_bwd.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        fused_ln_bwd_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfl._fused_ln_bwd_cuda(_meta(4, 8), _meta(8), _meta(4), _meta(4),
                               _meta(4, 8), 1e-5)


def test_kernel_source_names_what_it_replaces_and_its_bound():
    src = (_build.CSRC / "fused_ln_bwd.cu").read_text()
    assert "fused_ln.py `_bwd_kernel`" in src and "Bound:" in src
    assert "fused_ln_bwd" in _build.SOURCES
