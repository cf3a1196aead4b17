"""The arithmetic of the port's LayerNorm kernel
(paddle_tpu_torch/kernels/csrc/layer_norm.cu, row 14), emulated in float32
on the CPU in the kernel's order and held against the JAX package's
``layer_norm_2d`` (its Pallas forward run in interpret mode).

The kernel gives a row to a warp.  Where C % 4 == 0 and C <= 1024 (and
the pointers are 16-byte aligned, as every torch allocation is) lane l
holds the row's float4s l, l + 32, ...: it adds them component-wise, folds
the four partials as (x + y) + (z + w), and the warp sums the lanes by an
xor butterfly; the centred squares the same way (multiply-adds, one
rounding each).  Other rows take ln_rows.cuh: lane l holds columns l, l +
32, ... and adds them in turn before the same butterfly.  Tolerance: atol
1e-5 (f32 sums in another order than the reference's; outputs ~1).

The bf16 instantiation's plain version in the kernel's order
(``layer_norm_2d_bf16_kernel_order``, which the card's check holds the
kernel to within one bf16 ulp of y) is held here to the unordered plain
version and to the JAX package's ``layer_norm_2d`` on the same bf16 x:
one bf16 ulp of y, and past it BF16_OPERAND_ULPS f32 ulps of the
element's operands (|b| + the row's max|x| rstd |g|), since y is rounded
once from an f32 sum of two terms that summation order moves by an f32
ulp or so of the larger.
"""

import ctypes
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from paddle_tpu.pallas_kernels import layer_norm as jln
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import layer_norm as tln

ATOL = 1e-5
LANES = torch.arange(32)
BF16_OPERAND_ULPS = 8


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product of two f32 is exact in
    f64)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(part):
    """[R, 32] lane partials -> [R] as the xor butterfly sums them (every
    lane ends with the same value)."""
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, LANES ^ off]
    return part[:, 0]


def _lanes(t, width):
    """[R, C] (or [R, C // 4, 4]) -> [R, n, 32, width]: element i of lane
    l is item l + 32 i of the row, zeros past its end."""
    r, items = t.shape[0], t.shape[1]
    n = -(-items // 32)
    pad = torch.zeros((r, 32 * n) + tuple(t.shape[2:]), dtype=t.dtype)
    pad[:, :items] = t
    return pad.reshape(r, n, 32, width)


def vec_path(x, g, b, eps):
    """(y, mean, var) of the float4 kernel's order."""
    r, c = x.shape
    inv_h = torch.tensor(1.0, dtype=torch.float32) / c
    xv = _lanes(x.reshape(r, c // 4, 4), 4)
    valid = _lanes(torch.ones(r, c // 4, 4), 4) > 0
    acc = torch.zeros(r, 32, 4)
    for i in range(xv.shape[1]):
        acc = acc + xv[:, i]
    fold = lambda a: (a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3])  # noqa
    mu = _butterfly(fold(acc)) * inv_h
    cen = torch.where(valid, xv - mu[:, None, None, None], torch.zeros(()))
    acc = torch.zeros(r, 32, 4)
    for i in range(cen.shape[1]):
        acc = _fma(cen[:, i], cen[:, i], acc)
    var = _butterfly(fold(acc)) * inv_h
    rstd = torch.rsqrt(var + eps)
    gv, bv = (_lanes(t.reshape(1, c // 4, 4), 4) for t in (g, b))
    y = _fma(cen * rstd[:, None, None, None], gv, bv)
    y = y.reshape(r, -1)[:, :c]
    return y, mu, var


def scalar_path(x, g, b, eps):
    """(y, mean, var) of ln_rows.cuh's order (scalar loads)."""
    r, c = x.shape
    inv_h = torch.tensor(1.0, dtype=torch.float32) / c
    xs = _lanes(x, 1)[..., 0]
    valid = _lanes(torch.ones(r, c), 1)[..., 0] > 0
    part = torch.zeros(r, 32)
    for i in range(xs.shape[1]):
        part = part + xs[:, i]
    mu = _butterfly(part) * inv_h
    cen = torch.where(valid, xs - mu[:, None, None], torch.zeros(()))
    part = torch.zeros(r, 32)
    for i in range(cen.shape[1]):
        part = _fma(cen[:, i], cen[:, i], part)
    var = _butterfly(part) * inv_h
    rstd = torch.rsqrt(var + eps)
    gs, bs = (_lanes(t.reshape(1, c), 1)[..., 0] for t in (g, b))
    y = _fma(cen * rstd[:, None, None], gs, bs).reshape(r, -1)[:, :c]
    return y, mu, var


def kernel_order(x, g, b, eps):
    """The path layer_norm.cu takes for [R, C], in its order."""
    c = x.shape[1]
    if c % 4 == 0 and c <= 1024:
        return vec_path(x, g, b, eps)
    return scalar_path(x, g, b, eps)


class _Interpret:
    """``pl`` with every pallas_call in interpret mode (the CPU runs the
    reference's kernel body)."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*a, **kw):
        return pl.pallas_call(*a, interpret=True, **kw)


@pytest.mark.parametrize("rows,cols", [(64, 768), (16, 1024), (24, 200),
                                       (16, 202), (8, 1100)])
def test_kernel_order_matches_pallas_layer_norm(monkeypatch, rows, cols):
    """[64, 768] (BERT's width) and [16, 1024] on the float4 path, [24, 200]
    with its last float4 group short of a lane, [16, 202] (C % 4 != 0) and
    [8, 1100] (past 1024) on ln_rows.cuh's."""
    monkeypatch.setattr(jln, "pl", _Interpret())
    rng = np.random.RandomState(cols)
    x = (rng.randn(rows, cols) * 3.0 - 1.0).astype(np.float32)
    g = (rng.randn(cols) + 1.0).astype(np.float32)
    b = rng.randn(cols).astype(np.float32)
    want = jln.layer_norm_2d(x, g, b, 1e-5)
    got = kernel_order(*(torch.from_numpy(a) for a in (x, g, b)), 1e-5)
    for name, gv, wv in zip(("y", "mean", "var"), got, want):
        assert tuple(gv.shape) == np.asarray(wv).shape, name
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_wrapper_types_every_argument_of_the_c_entry(monkeypatch):
    """The ctypes types ``layer_norm_2d`` gives ``layer_norm_fwd_f32`` are
    the C entry's parameters, one for one: pointers, two ints, the float
    eps, the stream."""
    src = (_build.CSRC / "layer_norm.cu").read_text()
    decl = re.search(r'extern "C" cudaError_t layer_norm_fwd_f32\((.*?)\)',
                     src, re.S).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else kinds[p.split()[-2]] for p in decl.split(",")]

    class _Lib:
        layer_norm_fwd_f32 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    assert list(tln._kernel().argtypes) == want


def test_row_7_keeps_its_own_kernel():
    """layer_norm.cu has its float4 kernel beside ln_rows.cuh's, which it
    takes for the other rows; fused_ln.cu (row 7) reaches only
    ln_rows.cuh."""
    src = (_build.CSRC / "layer_norm.cu").read_text()
    assert "layer_norm_vec_kernel" in src and "float4" in src
    assert '#include "ln_rows.cuh"' in src and "ln_rows::launch(" in src
    fused = (_build.CSRC / "fused_ln.cu").read_text()
    assert "layer_norm_vec" not in fused and "ln_rows::launch(" in fused
    assert "layer_norm_vec" not in (_build.CSRC / "ln_rows.cuh").read_text()


def _ulp(t, bits):
    return torch.exp2(torch.floor(torch.log2(t.clamp_min(2.0 ** -126)))
                      - bits)


def _bf16_gap(got, want, x, g, b, var, eps):
    """(|got - want| in bf16 ulps of y at the worst element, the largest
    excess over one such ulp in f32 ulps of the element's operands)."""
    d = (got.float() - want.float()).abs()
    ulp_y = _ulp(torch.maximum(got.float().abs(), want.float().abs()), 7)
    ops = (x.float().abs().amax(dim=1, keepdim=True)
           * torch.rsqrt(var[:, None] + eps) * g.abs() + b.abs())
    return (float((d / ulp_y).max()),
            float(((d - ulp_y).clamp_min(0) / _ulp(ops, 23)).max()))


@pytest.mark.parametrize("rows,cols,vec", [(616, 768, True), (64, 200, True),
                                           (16, 1200, False),
                                           (24, 1104, False)])
def test_bf16_kernel_order_is_the_layer_norm(monkeypatch, rows, cols, vec):
    """The bf16 plain version in the kernel's order at the smoke's shapes
    ([616, 768], the MLM head's 614 rows rounded up to the reference
    kernel's row block, and [64, 200] on the 16-byte kernel, [16, 1200]
    past its 1024 columns on the scalar one, [24, 1104] too): bf16 y within one
    ulp plus BF16_OPERAND_ULPS of the unordered plain version's and of
    the JAX package's (its Pallas forward in interpret mode), the
    statistics to 1e-6 of their largest value."""
    monkeypatch.setattr(jln, "pl", _Interpret())
    rng = np.random.RandomState(rows + cols)
    x = (rng.randn(rows, cols) * 3.0 - 1.0).astype(np.float32)
    g = (rng.randn(cols) + 1.0).astype(np.float32)
    b = rng.randn(cols).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    assert tln.bf16_vec_ok(xt, gt, bt) == vec
    got = tln.layer_norm_2d_bf16_kernel_order(xt, gt, bt, 1e-5)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (rows, cols)
    plain = tln.layer_norm_2d_reference(xt, gt, bt, 1e-5)
    jy, jm, jv = jln.layer_norm_2d(
        jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16), g, b, 1e-5)
    jax_out = (torch.from_numpy(np.asarray(jy.astype(jnp.float32)))
               .to(torch.bfloat16), torch.from_numpy(np.asarray(jm)),
               torch.from_numpy(np.asarray(jv)))
    for want in (plain, jax_out):
        ulps, excess = _bf16_gap(got[0], want[0], xt, gt, bt, want[2], 1e-5)
        assert excess <= BF16_OPERAND_ULPS, (ulps, excess)
        for gs, ws in zip(got[1:], want[1:]):
            assert float((gs - ws).abs().max()) <= 1e-6 * max(
                float(ws.abs().max()), 1e-30)


def test_bf16_kernels_spell_out_their_arithmetic():
    """Both bf16 kernels of layer_norm.cu state every rounding of the
    statistics and of y in round-to-nearest intrinsics (so no
    contraction the compiler chooses moves y away from the plain version
    in the kernel's order): no bare ``* rstd * g + b`` is left."""
    src = (_build.CSRC / "layer_norm.cu").read_text()
    body = src[src.index("layer_norm_bf16_vec_kernel("):]
    body = body[:body.index("template <int NV>\ncudaError_t "
                            "launch_bf16_vec")]
    assert body.count("__fmaf_rn(") == 4 and body.count("__fsub_rn(") == 3
    assert body.count("rsqrtf(__fadd_rn(var_row, eps))") == 2
    assert "* rstd *" not in body and "* inv_h" not in body
