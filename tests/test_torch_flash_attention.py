"""Flash attention forward in the PyTorch port
(paddle_tpu_torch/kernels/flash_attention.py) held against the JAX
reference (paddle_tpu/pallas_kernels/flash_attention.py) on the CPU.

The port's ``flash_attention`` on CPU tensors (its plain version) must
give the output and the row log-sum-exp of the reference's Pallas forward
kernel run in interpret mode, at the reference test's shapes and blocks,
and of its ``_ref_attention`` at odd shapes the TPU kernel cannot tile
(S = 77, D = 40, a fully masked row), to atol 2e-5 (f32; online vs
one-shot softmax, as the reference's own interpret test allows).  The
CUDA branch is held to its contract without a card: it builds or raises
and never falls back to the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels.flash_attention import (_fwd_pallas,
                                                       _ref_attention)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa

ATOL = 2e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _jax_lse(q, k, bias, causal, scale):
    """Row log-sum-exp of the reference's scores, [B, H, Sq, 1]."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    if causal:
        qi = jax.lax.broadcasted_iota(jnp.int32, s.shape[-2:], 0)
        kj = jax.lax.broadcasted_iota(jnp.int32, s.shape[-2:], 1)
        s = jnp.where(kj <= qi, s, -1e30)
    return np.asarray(jax.scipy.special.logsumexp(s, axis=-1,
                                                  keepdims=True))


def _port(q, k, v, bias, causal, scale):
    t = [torch.from_numpy(np.ascontiguousarray(a)) if a is not None
         else None for a in (q, k, v, bias)]
    out, lse = tfa.flash_attention(*t, causal=causal, sm_scale=scale)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("blocks", [(128, 128), (128, 64)])
def test_matches_pallas_forward_in_interpret_mode(causal, with_bias, blocks):
    """The reference test's case (tests/test_flash_attention.py:27-43):
    B=1, H=2, S=256, D=64, a key-padding bias broadcast over rows."""
    rng = np.random.RandomState(0)
    bb, h, s, d = 1, 2, 256, 64
    q, k, v = (_rand(rng, bb, h, s, d) for _ in range(3))
    bias = None
    if with_bias:
        m = (np.random.RandomState(3).rand(bb, 1, 1, s) > 0.2).astype("f")
        bias = np.broadcast_to((1 - m) * -1e4, (bb, 1, s, s)).copy()
    scale = d ** -0.5
    want_out, want_lse = _fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), causal, scale,
        blocks[0], blocks[1], interpret=True)
    got_out, got_lse = _port(q, k, v, bias, causal, scale)
    np.testing.assert_allclose(got_out, np.asarray(want_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads_in_bias", [1, 3])
def test_odd_shapes_match_ref_attention(causal, heads_in_bias):
    """S=77, D=40 with a [B, 1|H, S, S] padding mask and one fully masked
    row (-1e30 everywhere), which both sides average to mean(V)."""
    rng = np.random.RandomState(1)
    bb, h, s, d = 2, 3, 77, 40
    q, k, v = (_rand(rng, bb, h, s, d) for _ in range(3))
    m = (rng.rand(bb, 1, 1, s) > 0.3).astype(np.float32)
    bias = np.broadcast_to((1 - m) * -1e4,
                           (bb, heads_in_bias, s, s)).copy()
    bias[:, :, 5, :] = -1e30
    scale = d ** -0.5
    want = np.asarray(_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(bias),
                                     causal, scale))
    got_out, got_lse = _port(q, k, v, bias, causal, scale)
    np.testing.assert_allclose(got_out, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got_lse, _jax_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(bias),
                          causal, scale), atol=ATOL, rtol=1e-6)
    if not causal:
        np.testing.assert_allclose(got_out[:, :, 5], v.mean(axis=2),
                                   atol=ATOL)


def test_unequal_q_and_k_lengths_and_default_scale():
    rng = np.random.RandomState(2)
    q = _rand(rng, 1, 2, 33, 16)
    k, v = _rand(rng, 1, 2, 50, 16), _rand(rng, 1, 2, 50, 16)
    want = np.asarray(_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), None, False,
                                     16 ** -0.5))
    out, lse = tfa.flash_attention(*(torch.from_numpy(a)
                                     for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
    assert lse.shape == (1, 2, 33, 1) and lse.dtype == torch.float32


def test_meta_tensors_give_shapes_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("shape inference must not build %s" % name)

    monkeypatch.setattr(_build, "load", no_build)
    q = torch.empty(3, 2, 9, 8, device="meta")
    out, lse = tfa.flash_attention(q, q, q)
    assert out.shape == (3, 2, 9, 8) and lse.shape == (3, 2, 9, 1)


def test_cpu_tensors_take_the_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("CPU tensors must not build %s" % name)

    monkeypatch.setattr(_build, "load", no_build)
    before = tfa.flash_attention.launches
    q = torch.randn(1, 1, 4, 8)
    tfa.flash_attention(q, q, q)
    assert tfa.flash_attention.launches == before


def test_cuda_branch_propagates_build_failure(monkeypatch):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    q = torch.empty(1, 1, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa._flash_cuda(q, q, q, None, False, 1.0)


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        flash_attention_fwd_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    q = torch.empty(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa._flash_cuda(q, q, q, None, False, 1.0)


def test_kernel_source_names_what_it_replaces_and_its_bound():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "paddle_tpu/pallas_kernels/flash_attention.py `_fwd_kernel`" \
        in src
    assert "Bound:" in src
    assert 'extern "C" cudaError_t flash_attention_fwd_f32' in src
    assert "flash_attention" in _build.SOURCES
