"""The dropout paths of the PyTorch port's ops (paddle_tpu_torch/ops/nn.py:
``dropout``/``dropout_grad``, ``flash_attention``/``_grad`` with
attention-prob dropout on both of its routes, ``fused_dropout_add_ln``/
``_grad`` at p > 0) held against the JAX package's lowerings on the CPU.

The two packages draw from different streams, so each reference lowering
has its draw point patched to return the port's mask for the op's key
words: ``ops.nn.bernoulli_bytes`` (the dropout op and the composed
attention) and ``pallas_kernels.fused_ln._fallback_keep``.  With the same
mask:

* dropout, both implementations, training and inference: Out and Mask
  equal the reference's exactly (the same f32 division), and so does
  dropout_grad;
* flash_attention, composed route (flag off): out and the saved Mask
  equal, grads to 2e-5 (f32 products in another order);
* flash_attention, small-sequence route (``FLAGS_fused_small_attention``
  on): out, Lse and Seed are the plain small kernel's, and the grad op
  re-draws the mask from Seed; at p = 0.25, where the byte draw's and the
  u32 draw's keep probabilities coincide (0.75 exactly), the small route
  gives the reference's composed route from the same mask, out to 1e-5
  and grads to 2e-5;
* fused_dropout_add_ln at p = 0.1, also under fix_seed: Out, R, Mean and
  Variance to 1e-5, the grads to 1e-5 (dScale, dBias to 1e-5 of their
  largest value: sums over rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.ops import nn as jnn
from paddle_tpu.pallas_kernels import fused_ln as jfl
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.ops.common import byte_threshold

ATOL = 1e-5
ATOL_GRAD = 2e-5
SEED = (0xABCDEF << 32) | 0x12345678
WORDS = philox.words_of(SEED)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jax(op_type, args, attrs):
    fn = jreg.get_op_def(op_type).lower
    out = fn(JCtx(rng_key=jax.random.key(0), mode="eager"),
             *[None if a is None else jnp.asarray(a) for a in args], **attrs)
    out = out if isinstance(out, tuple) else (out,)
    return [None if o is None else np.asarray(o) for o in out]


def _port(op_type, args, attrs, seed=SEED):
    fn = treg.get_op_def(op_type).lower
    out = fn(TCtx(torch.device("cpu"), seed=seed),
             *[None if a is None else torch.from_numpy(np.array(a))
               for a in args], **attrs)
    out = out if isinstance(out, tuple) else (out,)
    return [None if o is None else o.numpy() for o in out]


def _patch_bytes(monkeypatch, words):
    """The reference's byte draw returns the port's byte mask."""
    monkeypatch.setattr(
        jnn, "bernoulli_bytes",
        lambda key, keep_prob, shape: jnp.asarray(philox.keep_bytes(
            words, byte_threshold(keep_prob), shape).numpy()))


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("is_test", [False, True])
def test_dropout_and_grad_match_reference(monkeypatch, impl, is_test):
    _patch_bytes(monkeypatch, WORDS)
    rng = np.random.RandomState(0)
    x = _rand(rng, 4, 33, 17)
    attrs = {"dropout_prob": 0.1, "is_test": is_test, "fix_seed": False,
             "seed": 0, "dropout_implementation": impl}
    want = _jax("dropout", [x], attrs)
    got = _port("dropout", [x], attrs, seed=None if is_test else SEED)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if not is_test:
        assert 0.85 < got[1].mean() < 0.95
    dy = _rand(rng, *x.shape)
    gx = _port("dropout_grad", [got[1], dy], attrs)[0]
    np.testing.assert_array_equal(
        gx, _jax("dropout_grad", [want[1], dy], attrs)[0])


def test_dropout_fix_seed_keys_the_stream_by_the_attr(monkeypatch):
    attrs = {"dropout_prob": 0.5, "is_test": False, "fix_seed": True,
             "seed": 1234, "dropout_implementation": "upscale_in_train"}
    x = np.ones((64, 64), np.float32)
    a = _port("dropout", [x], attrs, seed=1)[1]
    b = _port("dropout", [x], attrs, seed=2)[1]
    np.testing.assert_array_equal(a, b)
    _patch_bytes(monkeypatch, philox.words_of(1234))
    np.testing.assert_array_equal(a, _jax("dropout", [x], attrs)[1])


def _attention(rng, bb=2, h=2, s=128, d=64):
    q, k, v, dout = (_rand(rng, bb, h, s, d) for _ in range(4))
    keep = (rng.rand(bb, 1, 1, s) > 0.2).astype(np.float32)
    keep[..., 0] = 1.0
    bias = np.ascontiguousarray(np.broadcast_to((1 - keep) * -1e4,
                                                (bb, 1, s, s)))
    return q, k, v, bias, dout


def _fa_attrs(p):
    return {"causal": False, "scale": 0.0, "layout": "BHSD",
            "dropout_prob": p, "is_test": False}


def _grad_args(q, k, v, bias, fwd, dout):
    out, mask, seed, lse = fwd
    return [q, k, v, bias, mask, out, seed, lse, dout]


@pytest.mark.parametrize("s", [16, 128])
def test_flash_attention_composed_route_matches_reference(monkeypatch, s):
    monkeypatch.setattr(tflags, "_flags",
                        {"FLAGS_fused_small_attention": False})
    _patch_bytes(monkeypatch, WORDS)
    rng = np.random.RandomState(1)
    q, k, v, bias, dout = _attention(rng, s=s, d=16)
    attrs = _fa_attrs(0.1)
    want = _jax("flash_attention", [q, k, v, bias], attrs)
    got = _port("flash_attention", [q, k, v, bias], attrs)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])     # the saved Mask
    wg = _jax("flash_attention_grad", _grad_args(q, k, v, bias, want, dout),
              attrs)
    gg = _port("flash_attention_grad", _grad_args(q, k, v, bias, got, dout),
               attrs)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g, w, atol=ATOL_GRAD, rtol=0)


def test_flash_attention_small_route_replays_its_mask(monkeypatch):
    monkeypatch.setattr(tflags, "_flags",
                        {"FLAGS_fused_small_attention": True})
    rng = np.random.RandomState(2)
    q, k, v, bias, dout = _attention(rng)
    attrs = _fa_attrs(0.1)
    got = _port("flash_attention", [q, k, v, bias], attrs)
    assert philox.seed_words(torch.from_numpy(got[2])) == WORDS
    assert got[1].shape == (1,) and got[3].shape == (2, 2, 128, 1)
    t = [torch.from_numpy(a) for a in (q, k, v, bias, dout)]
    out, lse = tfa.small_attention_fwd_reference(*t[:4], 0.125, 0.1, WORDS)
    np.testing.assert_array_equal(got[0], out.numpy())
    np.testing.assert_array_equal(got[3], lse.numpy())
    gg = _port("flash_attention_grad", _grad_args(q, k, v, bias, got, dout),
               attrs, seed=None)        # the grad draws nothing itself
    want = tfa.small_attention_bwd_reference(*t[:4], 0.125, 0.1, WORDS, out,
                                             lse, t[4])
    for g, w in zip(gg, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_small_route_equals_reference_composed_route_at_p25(monkeypatch):
    """The port's small kernel (u32 draw, times f32(4/3)) against the
    reference's composed route (byte draw, divided by 0.75), both fed the
    port's u32 mask: at p = 0.25 both keep probabilities are 0.75."""
    monkeypatch.setattr(tflags, "_flags",
                        {"FLAGS_fused_small_attention": True})
    thr = philox.keep_threshold(0.25)
    assert philox.realized_q(thr) == 0.75 == byte_threshold(0.75) / 256
    monkeypatch.setattr(
        jnn, "bernoulli_bytes",
        lambda key, keep_prob, shape: jnp.asarray(
            philox.keep_mask(WORDS, thr, shape).numpy()))
    rng = np.random.RandomState(3)
    q, k, v, bias, dout = _attention(rng)
    attrs = _fa_attrs(0.25)
    want = _jax("flash_attention", [q, k, v, bias], attrs)
    got = _port("flash_attention", [q, k, v, bias], attrs)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    wg = _jax("flash_attention_grad", _grad_args(q, k, v, bias, want, dout),
              attrs)
    gg = _port("flash_attention_grad", _grad_args(q, k, v, bias, got, dout),
               attrs)
    for g, w in zip(gg, wg):
        np.testing.assert_allclose(g, w, atol=ATOL_GRAD, rtol=0)


@pytest.mark.parametrize("fix_seed", [False, True])
def test_fused_dropout_add_ln_and_grad_match_reference(monkeypatch,
                                                       fix_seed):
    words = philox.words_of(77) if fix_seed else WORDS
    monkeypatch.setattr(
        jfl, "_fallback_keep",
        lambda seed, thr, shape: jnp.asarray(
            philox.keep_mask(words, thr, shape).numpy()))
    rng = np.random.RandomState(4)
    x, y = _rand(rng, 3, 5, 32, scale=2.0), _rand(rng, 3, 5, 32)
    g, b = _rand(rng, 32) + 1.0, _rand(rng, 32)
    attrs = {"dropout_prob": 0.1, "is_test": False, "epsilon": 1e-5,
             "begin_norm_axis": 2, "fix_seed": fix_seed, "seed": 77}
    want = _jax("fused_dropout_add_ln", [x, y, g, b], attrs)
    got = _port("fused_dropout_add_ln", [x, y, g, b], attrs)
    for gv, wv in zip(got[:4], want[:4]):
        np.testing.assert_allclose(gv, wv, atol=ATOL, rtol=0)
    assert philox.seed_words(torch.from_numpy(got[4])) == words
    dz = _rand(rng, *x.shape)
    wg = _jax("fused_dropout_add_ln_grad",
              [want[1], g, want[4], want[2], want[3], dz], attrs)
    gg = _port("fused_dropout_add_ln_grad",
               [got[1], g, got[4], got[2], got[3], dz], attrs, seed=None)
    for i, (gv, wv) in enumerate(zip(gg, wg)):
        atol = ATOL if i < 2 else ATOL * float(np.abs(wv).max())
        np.testing.assert_allclose(gv, wv, atol=atol, rtol=0)
    assert float(np.abs(gg[0] - gg[1]).max()) > 1e-3   # dy is dropped
