"""Small-sequence attention with in-kernel dropout in the PyTorch port
(paddle_tpu_torch/kernels/flash_attention.py ``small_attention_*``, rows
5 and 6 of PERF.md's kernel table) held against the JAX package on the
CPU.

* The port's plain forward and backward against the reference's own
  kernel bodies (``_small_fwd_kernel`` / ``_small_bwd_kernel``), run on
  the CPU with numpy arrays as their refs, one batch block at a time, with
  ``prng.seed_block_prng`` and ``prng.draw_keep_bits`` patched to return
  the port's Philox mask for that block (the TPU's on-core bits exist
  only on a TPU).  p in {0, 0.1}, the bias shared or per head, D in {64,
  128}, S = 128 and one S = 256 case; atol 1e-5 (f32; the reference takes
  the row max of the whole row, the port the same; sums in another
  order).
* Autograd of the plain forward equals the plain backward (atol 1e-5),
  and ``SmallAttention`` gives the plain backward's gradients.
* ``small_attention_shapes_ok`` routes as the reference's does.
* The backward kernel's order (one pass: a CTA per 64-key tile walks the
  query tiles, draws each tile pair's mask once by element index, dQ
  summed key tile by key tile) against the same kernel bodies, atol
  1e-5, at S in {128, 256}, D in {64, 128}, p in {0, 0.1}.
* The CUDA branches build or raise and never fall back; the sources name
  the TPU kernel each replaces and its bound.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels import prng as jprng
from paddle_tpu_torch.kernels import _build, philox
from paddle_tpu_torch.kernels import flash_attention as tfa

# the package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.pallas_kernels.flash_attention")

ATOL = 1e-5
WORDS = (0x1234, 0xBEEF)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, bb, h, s, d, bias_heads):
    rng = np.random.RandomState(seed)
    q, k, v, do = (_rand(rng, bb, h, s, d) for _ in range(4))
    bias = None
    if bias_heads:
        bias = _rand(rng, bb, bias_heads, s, s, scale=2.0)
        bias[..., -3:] = -1e4           # padded keys, as BERT's mask
    return q, k, v, bias, do


def _patch_prng(monkeypatch, keep, block):
    """The reference's kernel bodies draw their keep bits for batch block
    block["b"] from the port's mask."""
    monkeypatch.setattr(jprng, "seed_block_prng",
                        lambda seed_ref, grid_axis=0: None)
    monkeypatch.setattr(
        jprng, "draw_keep_bits",
        lambda shape, thr: jnp.asarray(keep[block["b"]].reshape(shape)))


def _reference(monkeypatch, q, k, v, bias, do, p):
    """(out, lse, dq, dk, dv) of the reference's kernel bodies."""
    bb, h, s, d = q.shape
    thr = jprng.keep_threshold(p)
    keep = None if thr is None else \
        philox.keep_mask(WORDS, thr, (bb, h, s, s)).numpy()
    block = {}
    _patch_prng(monkeypatch, keep, block)
    kw = dict(sm_scale=d ** -0.5, thr=thr, H=h, S=s, D=d,
              bias_per_head=bias is not None and bias.shape[1] != 1)
    seed_ref = np.asarray(WORDS, np.uint32)
    out = np.zeros_like(q)
    lse = np.zeros((bb, h, s, 1), np.float32)
    for b in range(bb):
        block["b"] = b
        sl = slice(b, b + 1)
        jfa._small_fwd_kernel(seed_ref, q[sl], k[sl], v[sl],
                              None if bias is None else bias[sl], out[sl],
                              lse[sl], **kw)
    delta = np.sum(do * out, axis=-1, keepdims=True)
    grads = [np.zeros_like(q) for _ in range(3)]
    for b in range(bb):
        block["b"] = b
        sl = slice(b, b + 1)
        jfa._small_bwd_kernel(seed_ref, q[sl], k[sl], v[sl],
                              None if bias is None else bias[sl], do[sl],
                              lse[sl], delta[sl], *(g[sl] for g in grads),
                              **kw)
    return (out, lse, *grads)


CASES = [  # (B, H, S, D), bias heads (0: none), p
    ((2, 2, 128, 64), 1, 0.1),
    ((2, 2, 128, 64), 2, 0.1),
    ((2, 2, 128, 128), 1, 0.1),
    ((2, 2, 128, 64), 1, 0.0),
    ((2, 2, 128, 128), 0, 0.1),
    ((1, 2, 256, 64), 2, 0.1),
]


@pytest.mark.parametrize("shape,bias_heads,p", CASES)
def test_plain_matches_reference_kernel_bodies(monkeypatch, shape, bias_heads,
                                               p):
    q, k, v, bias, do = _inputs(0, *shape, bias_heads)
    want = _reference(monkeypatch, q, k, v, bias, do, p)
    tb = None if bias is None else _t(bias)
    sm_scale = shape[3] ** -0.5
    seed_t = torch.empty(2, dtype=torch.int32)
    out, lse = tfa.small_attention_fwd(_t(q), _t(k), _t(v), tb, sm_scale, p,
                                       WORDS, seed_out=seed_t)
    assert philox.seed_words(seed_t) == WORDS
    grads = tfa.small_attention_bwd(_t(q), _t(k), _t(v), tb, sm_scale, p,
                                    seed_t, out, lse, _t(do))
    names = ("out", "lse", "dq", "dk", "dv")
    for name, g, w in zip(names, (out, lse) + tuple(grads), want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)


TILE = 64     # keys of a CTA's tile and rows of a query tile in the kernel


def _tile_keep(words, thr, bb, h, s, q0, k0):
    """Keep bits [B, H, 64, 64] of the tile pair (q0, k0), each drawn by
    its element index ((b * H + h) * S + i) * S + j, as the fused kernel
    draws them: lane e & 3 of counter e >> 2."""
    w0, w1 = philox.seed_words(words)
    head = torch.arange(bb * h, dtype=torch.int64).reshape(bb, h, 1, 1)
    rows = torch.arange(q0, q0 + TILE, dtype=torch.int64)[:, None]
    cols = torch.arange(k0, k0 + TILE, dtype=torch.int64)[None, :]
    e = (head * s + rows) * s + cols
    ctr = e >> 2
    zero = torch.zeros_like(ctr)
    lanes = torch.stack(philox.philox4x32(ctr & 0xFFFFFFFF, ctr >> 32, zero,
                                          zero, w0, w1), dim=-1)
    return lanes.gather(-1, (e & 3)[..., None])[..., 0] < thr


def _fused_order_bwd(q, k, v, bias, do, lse, delta, scale, p):
    """(dq, dk, dv) as csrc/small_attention_bwd.cu (flash_bwd.cuh with
    the mask) associates them: each 64-key tile walks the query tiles,
    draws the pair's mask once, and sums its dK and dV over them; dQ is
    zeros plus one term per key tile, in key order."""
    bb, h, s, d = q.shape
    thr = philox.keep_threshold(p)
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for k0 in range(0, s, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        dk = torch.zeros_like(kt)
        dv = torch.zeros_like(vt)
        for q0 in range(0, s, TILE):
            qt, dot = q[:, :, q0:q0 + TILE], do[:, :, q0:q0 + TILE]
            x = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
            if bias is not None:
                x = x + bias[:, :, q0:q0 + TILE, k0:k0 + TILE]
            prob = torch.exp(x - lse[:, :, q0:q0 + TILE])
            dp = torch.einsum("bhqd,bhkd->bhqk", dot, vt)
            pd = prob
            if thr is not None:
                keep = _tile_keep(WORDS, thr, bb, h, s, q0, k0)
                inv_q = philox.inv_realized_q(thr)
                dp = torch.where(keep, dp * inv_q, torch.zeros(()))
                pd = torch.where(keep, prob * inv_q, torch.zeros(()))
            ds = prob * (dp - delta[:, :, q0:q0 + TILE]) * scale
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", pd, dot)
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qt)
            dq[:, :, q0:q0 + TILE] = dq[:, :, q0:q0 + TILE] + torch.einsum(
                "bhqk,bhkd->bhqd", ds, kt)
        dks.append(dk)
        dvs.append(dv)
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("shape,bias_heads", [
    ((2, 2, 128, 64), 1), ((1, 2, 256, 64), 2), ((1, 2, 128, 128), 1),
    ((1, 1, 256, 128), 1)])
def test_fused_kernel_order_matches_reference_kernel_body(monkeypatch, shape,
                                                          bias_heads, p):
    """The one-pass kernel's tiling and mask draw (a keep tile per tile
    pair, by element index) against the reference's ``_small_bwd_kernel``
    under the shared mask, S = 128 (two key tiles) and 256 (four), D = 64
    and 128."""
    q, k, v, bias, do = _inputs(3, *shape, bias_heads)
    out, lse, *want = _reference(monkeypatch, q, k, v, bias, do, p)
    tout, tdo = _t(out), _t(do)
    got = _fused_order_bwd(_t(q), _t(k), _t(v), _t(bias), tdo, _t(lse),
                           tfa.attention_delta(tout, tdo), shape[3] ** -0.5,
                           p)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_autograd_of_plain_forward_is_plain_backward(p):
    q, k, v, bias, do = _inputs(1, 2, 3, 128, 64, 1)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.small_attention_fwd_reference(*leaves, _t(bias), 0.125, p,
                                                 WORDS)
    want = torch.autograd.grad(out, leaves, _t(do))
    got = tfa.small_attention_bwd_reference(
        *(x.detach() for x in leaves), _t(bias), 0.125, p, WORDS,
        out.detach(), lse.detach(), _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)
    fn_grads = torch.autograd.grad(
        tfa.small_attention(*leaves, _t(bias), 0.125, p, WORDS), leaves,
        _t(do))
    for g, w in zip(fn_grads, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)


def test_dropout_changes_the_output():
    """At p = 0.1 the mask is in effect: the output moves from p = 0's."""
    q, k, v, bias, _do = _inputs(2, 1, 2, 128, 64, 1)
    a = tfa.small_attention_fwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                          0.125, 0.0, WORDS)[0]
    b = tfa.small_attention_fwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                          0.125, 0.1, WORDS)[0]
    assert float((a - b).abs().max()) > 1e-2


@pytest.mark.parametrize("q_shape,bias_shape,causal,layout", [
    ((2, 12, 128, 64), (2, 1, 128, 128), False, "BHSD"),
    ((2, 12, 256, 128), (2, 12, 256, 256), False, "BHSD"),
    ((2, 12, 128, 64), None, False, "BHSD"),
    ((2, 12, 128, 64), (2, 1, 1, 128), False, "BHSD"),
    ((2, 12, 128, 64), (2, 1, 128, 128), True, "BHSD"),
    ((2, 12, 128, 64), (2, 1, 128, 128), False, "BSHD"),
    ((2, 12, 384, 64), None, False, "BHSD"),
    ((2, 12, 64, 64), None, False, "BHSD"),
    ((2, 12, 128, 32), None, False, "BHSD"),
])
def test_shapes_predicate_equals_reference(q_shape, bias_shape, causal,
                                           layout):
    got = tfa.small_attention_shapes_ok(q_shape, q_shape, bias_shape, causal,
                                        layout)
    assert got == jfa.small_attention_shapes_ok(q_shape, q_shape, bias_shape,
                                                causal, layout)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("fn,args", [
    ("_small_fwd_cuda", lambda: (_meta(2, 2, 128, 64), _meta(2, 2, 128, 64),
                                 _meta(2, 2, 128, 64), None, 0.125, 0.1,
                                 WORDS, None)),
    ("_small_bwd_cuda", lambda: (_meta(2, 2, 128, 64), _meta(2, 2, 128, 64),
                                 _meta(2, 2, 128, 64), None, 0.125, 0.1,
                                 None, _meta(2, 2, 128, 64),
                                 _meta(2, 2, 128, 1), _meta(2, 2, 128, 64))),
])
def test_cuda_branch_builds_or_raises(monkeypatch, fn, args):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    counter = (tfa.small_attention_fwd if "fwd" in fn
               else tfa.small_attention_bwd)
    before = counter.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        getattr(tfa, fn)(*args())

    class _Lib:
        small_attention_fwd_f32 = small_attention_bwd_f32 = \
            staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    with pytest.raises(ValueError, match="not a CUDA device"):
        getattr(tfa, fn)(*args())
    assert counter.launches == before


def test_kernel_sources_name_what_they_replace_and_their_bound():
    for name, replaces in (
            ("small_attention", "flash_attention.py\n// `_small_fwd_kernel`"),
            ("small_attention_bwd",
             "flash_attention.py\n// `_small_bwd_kernel`")):
        src = (_build.CSRC / (name + ".cu")).read_text()
        assert replaces in src and "Bound:" in src
        assert name in _build.SOURCES
    # the backward is the fused flash backward's core with the mask
    src = (_build.CSRC / "small_attention_bwd.cu").read_text()
    assert '#include "flash_bwd.cuh"' in src and "launch_any<true>" in src
    assert "keep_tile" in (_build.CSRC / "flash_bwd.cuh").read_text()
