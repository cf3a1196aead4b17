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
* The kernel's float4 mask draw (one Philox group per run of four
  columns), its geometry and the order in which it adds the dgamma and
  dbeta partials, emulated in torch, are held to the stream and to the
  plain version.
* The CUDA branch builds or raises and never falls back."""

import ctypes
import re

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
    # the float4 path: one Philox group a run, the strip reduction; the
    # scalar kernel kept for the other rows; no atomics anywhere
    assert "fused_ln_bwd_vec" in src and "fused_ln_bwd_rows" in src
    assert "philox::group(base + c, k0, k1)" in src
    assert "reduce_partials<float4, 8, 32>" in src
    assert "reduce_partials<float, 32, 8>" in src
    assert "atomic" not in src.lower().replace("no atomics", "")


# -- the float4 kernel, emulated ----------------------------------------------

def _float4_keep(words, thr, row0, rows, h):
    """The kernel's draw: the run of columns 4 c .. 4 c + 3 of row ``row``
    takes the four words of Philox counter row * h / 4 + c, one call."""
    k0, k1 = philox.seed_words(words)
    row = torch.arange(row0, row0 + rows, dtype=torch.int64)[:, None]
    ctr = row * (h // 4) + torch.arange(h // 4, dtype=torch.int64)[None, :]
    zero = torch.zeros_like(ctr)
    lanes = philox.philox4x32(ctr & 0xFFFFFFFF, ctr >> 32, zero, zero, k0,
                              k1)
    return torch.stack([w < thr for w in lanes], dim=-1).reshape(rows, h)


def _element_keep(words, thr, row0, rows, h):
    """The scalar kernel's draw: element e takes lane e & 3 of counter
    e >> 2, one call an element."""
    k0, k1 = philox.seed_words(words)
    e = (torch.arange(row0, row0 + rows, dtype=torch.int64)[:, None] * h
         + torch.arange(h, dtype=torch.int64)[None, :])
    ctr = e >> 2
    zero = torch.zeros_like(ctr)
    lanes = torch.stack(philox.philox4x32(ctr & 0xFFFFFFFF, ctr >> 32, zero,
                                          zero, k0, k1), dim=-1)
    return lanes.gather(-1, (e & 3)[..., None])[..., 0] < thr


@pytest.mark.parametrize("row0", [0, 37])
def test_float4_mask_draw_is_the_forwards_stream(row0):
    """At h = 768, p = 0.1, from row 0 and from an odd row: bit for bit
    ``philox.keep_mask``, the mask of the forward and the plain version."""
    words, thr, h = (0x5EED, 0xC0DE), philox.keep_threshold(0.1), 768
    got = _float4_keep(words, thr, row0, 5, h)
    want = philox.keep_mask(words, thr, (row0 + 5, h))[row0:]
    assert torch.equal(got, want)
    assert 0.85 < float(got.float().mean()) < 0.95


def test_float4_mask_draw_past_a_32_bit_counter():
    """Rows whose counters cross 2^32 (the high word of the counter): one
    group a run equals one group an element."""
    words, thr, h = (0xFACE, 0xB00C), philox.keep_threshold(0.1), 768
    row0 = (1 << 32) // (h // 4) - 1
    assert torch.equal(_float4_keep(words, thr, row0, 3, h),
                       _element_keep(words, thr, row0, 3, h))


@pytest.mark.parametrize("n", [1, 37, 614, 4096, 100003])
def test_backward_geometry_covers_every_row_and_column(n):
    """Rows: CTA i's warp w takes rows i * rows + w, + 4, ... below the
    CTA's end, each row once, every CTA at least one (each writes a
    partial).  Columns at h = 768: lane l takes float4 runs l + 32 i.  The
    reduction: CTA x takes runs 8 x .. 8 x + 7, slice k partials k, k +
    32, ..., each partial once."""
    rows, ctas = tfl._bwd_grid(n)
    assert rows % 4 == 0 and rows * (ctas - 1) < n <= rows * ctas
    seen = np.zeros(n, np.int64)
    start = np.arange(ctas)[:, None] * rows
    end = np.minimum(n, start + rows)
    for w in range(4):
        r = start + w + 4 * np.arange(rows // 4)[None, :]
        np.add.at(seen, r[r < end], 1)
    assert (seen == 1).all()
    h4 = 768 // 4
    lanes = (np.arange(32)[:, None] + 32 * np.arange(-(-h4 // 32))).ravel()
    assert sorted(lanes[lanes < h4]) == list(range(h4))
    strips = (np.arange(-(-h4 // 8))[:, None] * 8 + np.arange(8)).ravel()
    assert sorted(strips[strips < h4]) == list(range(h4))
    parts = np.concatenate([np.arange(k, ctas, 32) for k in range(32)])
    assert sorted(parts) == list(range(ctas))


def _kernel_sums(dz, xhat, rows, ctas):
    """dgamma and dbeta in the kernel's order: each warp adds its rows
    into its slice, the CTA adds its 4 slices in order, the reduction's
    32 slices add their partials in order, then a fixed tree."""
    n, h = dz.shape
    g_part = torch.zeros(ctas, h)
    b_part = torch.zeros(ctas, h)
    for i in range(ctas):
        sg = torch.zeros(4, h)
        sb = torch.zeros(4, h)
        for w in range(4):
            for row in range(i * rows + w, min(n, (i + 1) * rows), 4):
                sg[w] += dz[row] * xhat[row]
                sb[w] += dz[row]
        g_part[i] = ((sg[0] + sg[1]) + sg[2]) + sg[3]
        b_part[i] = ((sb[0] + sb[1]) + sb[2]) + sb[3]
    out = []
    for part in (g_part, b_part):
        sl = [torch.zeros(h) for _ in range(32)]
        for k in range(32):
            for i in range(k, ctas, 32):
                sl[k] = sl[k] + part[i]
        st = 16
        while st:
            sl = [sl[k] + sl[k + st] for k in range(st)]
            st //= 2
        out.append(sl[0])
    return out


def test_partials_in_the_kernels_order_match_the_reference():
    """At [614, 768] (154 CTAs of 4 rows), the kernel's summation order
    of dgamma and dbeta equals the reference's sums to SUM_RTOL."""
    n, h = 614, 768
    rng = np.random.RandomState(5)
    x, y, dz = (_rand(rng, n, h) for _ in range(3))
    g, b = _rand(rng, h, shift=1.0), _rand(rng, h)
    seed = np.zeros(2, np.uint32)
    _z, r, mean, var = jfl.fused_ln_fwd(x, y, g, b, 0.0, seed, 1e-5, 1)
    want = jfl.fused_ln_bwd(r, g, seed, mean, var, dz, 0.0, 1e-5, 1)
    xhat = (_t(r) - _t(mean)[:, None]) * torch.rsqrt(_t(var)[:, None]
                                                      + 1e-5)
    rows, ctas = tfl._bwd_grid(n)
    assert (rows, ctas) == (4, 154)
    for got, wv in zip(_kernel_sums(_t(dz), xhat, rows, ctas), want[2:]):
        wv = np.asarray(wv)
        np.testing.assert_allclose(got.numpy(), wv, rtol=0,
                                   atol=SUM_RTOL * float(np.abs(wv).max()))


def test_wrapper_types_every_argument_of_the_c_entry(monkeypatch):
    """The ctypes types of ``fused_ln_bwd_f32`` are the C entry's
    parameters, one for one: ten pointers, two ints, eps, two ints, the
    unsigned threshold, the seed pointer, inv_q, the stream."""
    src = (_build.CSRC / "fused_ln_bwd.cu").read_text()
    decl = re.search(r'extern "C" cudaError_t fused_ln_bwd_f32\((.*?)\)',
                     src, re.S).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "unsigned int": ctypes.c_uint}
    want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else kinds[" ".join(p.split()[:-1])] for p in decl.split(",")]

    class _Lib:
        fused_ln_bwd_f32 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    assert len(want) == 19
    assert list(tfl._bwd_kernel().argtypes) == want
