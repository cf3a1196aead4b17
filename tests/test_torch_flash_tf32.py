"""The arithmetic of the port's flash-attention forward kernel
(paddle_tpu_torch/kernels/csrc/flash_attention.cu, row 2), emulated in
plain PyTorch on the CPU and held against the JAX package's Pallas forward
in interpret mode.

The kernel computes s = q . k and p . v on the tensor cores in 3xTF32
(the conv kernel's arithmetic, tests/test_torch_conv_tf32.py, whose
splits this file imports): each f32 operand is split into big, rounded to
TF32 (``cvt.rna``), and small = v - big, of which the tensor core reads
the top 10 mantissa bits; each m16n8k8 step adds small*big, big*small and
big*big, 8 products each, into its accumulator and cuts (rounds toward
zero) the sum.  Each 32-deep slice is summed there from zero and added
into f32 registers: s over D in slices of 32, p . v over a tile of 32
keys.  ``fwd_3xtf32`` below does the same arithmetic in the kernel's order:
key tiles of 32, the online softmax (running max from -1e30, row sum,
output rescaled by exp(m_old - m_new)), causal key tiles past the CTA's
last row skipped.

Tolerances: against the reference's Pallas forward and its ``_ref_attention``
2e-5 (KERNEL_ATOL of chip_smoke.py, which holds the card's kernel to its
plain version; outputs ~1, online vs one-shot softmax).  At BERT's head
width 1xTF32 (big*big alone) misses that limit ~25x (5.5e-4) while 3xTF32
stays ~20x inside it (9.5e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu.pallas_kernels.flash_attention import (_fwd_pallas,
                                                       _ref_attention)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_conv_tf32 import split_tf32

ATOL = cs.KERNEL_ATOL
KEYS = 32      # keys of a tile in the kernel
MASK = -1e30   # the kernel's (and the reference's) finite mask


def _cut(exact):
    """f64 -> f32 rounded toward zero: the tensor core's accumulator."""
    f = exact.float()
    over = f.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(acc, a, b):
    """acc [.., M, N] f32 plus a [.., M, 8] . b [.., N, 8] (TF32 values),
    the sum cut as the tensor core cuts it."""
    return _cut(acc.double() + torch.einsum("...mk,...nk->...mn", a.double(),
                                            b.double()))


def _product(a, b, passes):
    """a [.., M, K] . b [.., N, K]^T as the kernel sums one 32-deep slice:
    from zero, one m16n8k8 step per 8 of K; passes 3: small*big, big*small,
    big*big (3xTF32); 1: big*big alone (1xTF32)."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ab, asm = split_tf32(a[..., k0:k0 + 8])
        bb, bsm = split_tf32(b[..., k0:k0 + 8])
        if passes == 3:
            acc = _mma(acc, asm, bb)
            acc = _mma(acc, ab, bsm)
        acc = _mma(acc, ab, bb)
    return acc


def fwd_3xtf32(q, k, v, bias, causal, scale, rows=64, passes=3, keep=None,
               inv_q=1.0):
    """(out, lse) of the kernel's arithmetic and order; ``rows``: query
    rows a CTA (the causal skip is per CTA).  ``keep`` [B, H, Sq, Sk]
    (bool): the small forward's dropout (flash_fwd.cuh with kDrop), the
    row sum taking the undropped p and p . v's A operand ``keep ? p *
    inv_q : 0`` in f32."""
    bb, h, sq, d = q.shape
    sk = k.shape[2]
    dp = -(-d // 8) * 8                       # D padded with zeros to 8
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))  # noqa
    q, k, v = pad(q), pad(k), pad(v)
    outs, lses = [], []
    for q0 in range(0, sq, rows):
        qt = q[:, :, q0:q0 + rows]
        nr = qt.shape[2]
        m = torch.full((bb, h, nr, 1), MASK)
        l = torch.zeros((bb, h, nr, 1))
        o = torch.zeros((bb, h, nr, dp))
        nkt = -(-sk // KEYS)
        if causal:
            nkt = min(nkt, (min(sq, q0 + rows) - 1) // KEYS + 1)
        for kt in range(nkt):
            k0 = kt * KEYS
            kt_, vt = k[:, :, k0:k0 + KEYS], v[:, :, k0:k0 + KEYS]
            s = torch.zeros((bb, h, nr, kt_.shape[2]))
            for d0 in range(0, dp, 32):
                s = s + _product(qt[..., d0:d0 + 32], kt_[..., d0:d0 + 32],
                                 passes)
            x = s * scale
            if bias is not None:
                x = x + bias[:, :, q0:q0 + nr, k0:k0 + KEYS]
            if causal:
                above = torch.arange(k0, k0 + x.shape[-1])[None, :] \
                    > torch.arange(q0, q0 + nr)[:, None]
                x = x.masked_fill(above, MASK)
            mx = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp(m - mx)
            p = torch.exp(x - mx)
            l = l * alpha + p.sum(-1, keepdim=True)
            m = mx
            if keep is not None:
                kp = keep[:, :, q0:q0 + nr, k0:k0 + KEYS]
                p = torch.where(kp, p * inv_q, torch.zeros(()))
            o = o * alpha + _product(p, vt.transpose(-1, -2), passes)
        ll = torch.where(l == 0, torch.ones_like(l), l)
        outs.append(o[..., :d] / ll)
        lses.append(m + torch.log(ll))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _key_padding(rng, bb, s):
    keep = (rng.rand(bb, 1, 1, s) > 0.25).astype(np.float32)
    keep[..., 0] = 1.0
    return np.ascontiguousarray(np.broadcast_to((1.0 - keep) * -1e4,
                                                (bb, 1, s, s)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows", [16 * w for w in tfa.FWD_WARPS])
def test_3xtf32_matches_pallas_forward(causal, with_bias, rows):
    """The reference test's case (B=1, H=2, S=256, D=64, key padding) at
    each CTA shape of the kernel."""
    rng = np.random.RandomState(0)
    bb, h, s, d = 1, 2, 256, 64
    q, k, v = (_rand(rng, bb, h, s, d) for _ in range(3))
    bias = _key_padding(rng, bb, s) if with_bias else None
    scale = d ** -0.5
    out, lse = _fwd_pallas(q, k, v, None if bias is None
                           else jnp.asarray(bias), causal, scale, 128, 128,
                           interpret=True)
    got_o, got_l = fwd_3xtf32(_t(q), _t(k), _t(v), _t(bias), causal, scale,
                              rows)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(lse), rtol=0,
                               atol=ATOL)


def test_3xtf32_odd_shape_and_masked_row_match_reference():
    """S = 77 (a ragged key tile), D = 40 (padded to 40 + 0), a fully
    masked row (mean(V)), against the reference's ``_ref_attention``."""
    rng = np.random.RandomState(1)
    bb, h, s, d = 2, 3, 77, 40
    q, k, v = (_rand(rng, bb, h, s, d) for _ in range(3))
    bias = np.zeros((bb, 1, s, s), np.float32)
    bias[:, :, 5, :] = -1e30
    want = np.asarray(_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(bias),
                                     False, d ** -0.5))
    got, _lse = fwd_3xtf32(_t(q), _t(k), _t(v), _t(bias), False, d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[:, :, 5].numpy(), v.mean(axis=2), rtol=0,
                               atol=ATOL)


def test_1xtf32_misses_kernel_atol_where_3xtf32_holds():
    """At BERT's head width (D = 64, S = 128) one TF32 product per f32
    product lands past KERNEL_ATOL; the 3xTF32 split stays well inside."""
    rng = np.random.RandomState(2)
    bb, h, s, d = 1, 2, 128, 64
    q, k, v = (_t(_rand(rng, bb, h, s, d)) for _ in range(3))
    bias = _t(_key_padding(rng, bb, s))
    want = tfa.flash_attention_reference(q.double(), k.double(), v.double(),
                                         bias.double(), False, d ** -0.5)
    errs = {}
    for passes in (3, 1):
        got = fwd_3xtf32(q, k, v, bias, False, d ** -0.5, passes=passes)
        errs[passes] = max(float((g.double() - w).abs().max())
                           for g, w in zip(got, want))
    assert errs[3] < ATOL / 5, errs
    assert errs[1] > 5 * ATOL, errs


def test_shared_device_code_is_included_not_copied():
    """split_tf32, mma_tf32 and the cp.async helpers live in mma_tf32.cuh,
    included by the conv and attention kernels; the forward's core lives
    in flash_fwd.cuh, instantiated by row 2 and, with the mask (kDrop), by
    row 5; the fused backward's core lives in flash_bwd.cuh, instantiated
    by rows 3-4 and row 6."""
    header = (_build.CSRC / "mma_tf32.cuh").read_text()
    for helper in ("split_tf32", "mma_tf32", "cp_async16", "cp_async4",
                   "cp_async_wait"):
        assert "void %s(" % helper in header
    for name in ("conv_block.cu", "flash_fwd.cuh"):
        src = (_build.CSRC / name).read_text()
        assert '#include "mma_tf32.cuh"' in src
        assert "void split_tf32(" not in src and "void mma_tf32(" not in src
    assert "mma.sync.aligned.m16n8k8" not in (
        _build.CSRC / "flash_fwd.cuh").read_text()
    fwd = (_build.CSRC / "flash_fwd.cuh").read_text()
    assert "flash_fwd_kernel" in fwd and "bool kDrop" in fwd
    assert "keep_bits" in fwd and '#include "philox.cuh"' in fwd
    for name, drop in (("flash_attention", "false"),
                       ("small_attention", "true")):
        src = (_build.CSRC / (name + ".cu")).read_text()
        assert '#include "flash_fwd.cuh"' in src
        assert "__global__" not in src and "mma_tf32(" not in src
        assert ", %s>(" % drop in src
    core = (_build.CSRC / "flash_bwd.cuh").read_text()
    assert "flash_bwd_kernel" in core and "kSmall" in core
    for name in ("flash_attention_bwd", "small_attention_bwd"):
        src = (_build.CSRC / (name + ".cu")).read_text()
        assert '#include "flash_bwd.cuh"' in src
        assert "__global__" not in src


def test_forward_wrapper_refuses_a_tile_it_has_not(monkeypatch):
    class _Lib:
        flash_attention_fwd_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    q = torch.empty(1, 1, 4, 8, device="meta")
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match=r"warps 3 not in \(2, 4, 8\)"):
        tfa._flash_cuda(q, q, q, None, False, 1.0, warps=3)
    for w in tfa.FWD_WARPS:
        with pytest.raises(ValueError, match="not a CUDA device"):
            tfa._flash_cuda(q, q, q, None, False, 1.0, warps=w)
    assert tfa.FWD_DEFAULT_WARPS in tfa.FWD_WARPS
    assert tfa.flash_attention.launches == before
