"""Flash attention backward in the PyTorch port
(paddle_tpu_torch/kernels/flash_attention.py) held against the JAX
reference (paddle_tpu/pallas_kernels/flash_attention.py) on the CPU.

* The port's ``flash_attention_bwd`` on CPU tensors (its plain version,
  the recompute scheme of the reference's kernels: p = exp(s - lse)) gives
  the dQ, dK and dV of the reference's Pallas backward kernels run in
  interpret mode (``_bwd_pallas(..., interpret=True)``), at the reference
  test's shape and blocks, from the same forward out and lse: atol 2e-5
  (f32; the two recompute the same products in other orders).
* At odd shapes the TPU kernels cannot tile (S = 77, D = 40; S = 33), with
  a bias shared by the heads or one per head, causal or not, and a fully
  masked row, it gives ``jax.vjp`` of the reference's ``_ref_attention``:
  atol 2e-5, where every row keeps a real key; the fully masked row's
  weights are the forward's 1 / Sk there.
* ``flash_attention_train`` (a ``torch.autograd.Function``) gives the same
  gradients by autograd and under ``torch.func.vjp``.
* The CUDA branches build or raise and never fall back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels.flash_attention import (_bwd_pallas,
                                                       _fwd_pallas,
                                                       _ref_attention)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa

ATOL = 2e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _key_padding(rng, bb, heads, sq, sk):
    """-1e4 at padded keys (key 0 always kept), per head when heads > 1."""
    keep = (rng.rand(bb, heads, 1, sk) > 0.2).astype(np.float32)
    keep[..., 0] = 1.0
    return np.ascontiguousarray(np.broadcast_to((1 - keep) * -1e4,
                                                (bb, heads, sq, sk)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("blocks", [(128, 128), (128, 64), (64, 128)])
def test_matches_pallas_backward_in_interpret_mode(causal, with_bias,
                                                   blocks):
    """The reference test's case (tests/test_flash_attention.py:46-66):
    B=1, H=1, S=256, D=64, a key-padding bias broadcast over rows."""
    rng = np.random.RandomState(0)
    bb, h, s, d = 1, 1, 256, 64
    q, k, v, do = (_rand(rng, bb, h, s, d) for _ in range(4))
    bias = _key_padding(rng, bb, 1, s, s) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    out, lse = _fwd_pallas(q, k, v, jb, causal, d ** -0.5, blocks[0],
                           blocks[1], interpret=True)
    want = _bwd_pallas(q, k, v, jb, causal, d ** -0.5, blocks[0], blocks[1],
                       True, out, lse, do)
    got = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(bias), _t(out),
                                  _t(lse), _t(do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)


ODD = {
    "S=77 D=40 shared bias, a fully masked row": (2, 3, 77, 40, False,
                                                  "masked"),
    "S=33 D=16 bias per head, causal": (2, 2, 33, 16, True, "per-head"),
    "S=20 D=8 no bias": (2, 2, 20, 8, False, None),
    "S=50 D=24 shared bias": (1, 4, 50, 24, False, "shared"),
}


@pytest.mark.parametrize("case", sorted(ODD))
def test_matches_vjp_of_reference_at_odd_shapes(case):
    bb, h, s, d, causal, kind = ODD[case]
    rng = np.random.RandomState(1)
    q, k, v, do = (_rand(rng, bb, h, s, d) for _ in range(4))
    bias = None
    if kind == "masked":
        bias = _key_padding(rng, bb, 1, s, s)
        bias[:, :, 5, :] = -1e30
    elif kind == "per-head":
        bias = _key_padding(rng, bb, h, s, s)
    elif kind == "shared":
        bias = _key_padding(rng, bb, 1, s, s)
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda a, b, c: _ref_attention(a, b, c, jb, causal,
                                                    d ** -0.5), q, k, v)
    want = vjp(jnp.asarray(do))
    out, lse = tfa.flash_attention(_t(q), _t(k), _t(v), _t(bias), causal)
    got = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(bias), out, lse,
                                  _t(do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_split_plain_versions_make_the_whole_backward():
    rng = np.random.RandomState(2)
    q, k, v, do = (_t(_rand(rng, 2, 2, 9, 8)) for _ in range(4))
    out, lse = tfa.flash_attention(q, k, v)
    delta = tfa.attention_delta(out, do)
    dq = tfa.flash_attention_bwd_dq_reference(q, k, v, None, do, lse, delta)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(q, k, v, None, do, lse,
                                                   delta)
    for a, b in zip((dq, dk, dv), tfa.flash_attention_bwd(q, k, v, None,
                                                          out, lse, do)):
        assert torch.equal(a, b)


def test_autograd_function_and_func_vjp():
    rng = np.random.RandomState(3)
    q, k, v, do = (_t(_rand(rng, 2, 3, 12, 8)) for _ in range(4))
    bias = _t(_key_padding(rng, 2, 1, 12, 12))
    out, lse = tfa.flash_attention(q, k, v, bias)
    want = tfa.flash_attention_bwd(q, k, v, bias, out, lse, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention_train(*leaves, bias)
    torch.testing.assert_close(o, out, atol=0, rtol=0)
    o.backward(do)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)
    o2, vjp = torch.func.vjp(
        lambda a, b, c: tfa.flash_attention_train(a, b, c, bias), q, k, v)
    for g, w in zip(vjp(do), want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_meta_tensors_take_the_plain_path(monkeypatch):
    def no_build(name):
        raise AssertionError("meta tensors must not build %s" % name)

    monkeypatch.setattr(_build, "load", no_build)
    q = torch.empty(3, 2, 9, 8, device="meta")
    lse = torch.empty(3, 2, 9, 1, device="meta")
    dq, dk, dv = tfa.flash_attention_bwd(q, q, q, None, q, lse, q)
    assert dq.shape == dk.shape == dv.shape == (3, 2, 9, 8)


@pytest.mark.parametrize("which", ["flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"])
def test_cuda_branch_propagates_build_failure(monkeypatch, which):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    q = torch.empty(1, 1, 4, 8, device="meta")
    lse = torch.empty(1, 1, 4, 1, device="meta")
    before = getattr(tfa, which).launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        getattr(tfa, which)(q, q, q, None, q, lse, lse)
    assert getattr(tfa, which).launches == before


@pytest.mark.parametrize("which", ["flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"])
def test_kernel_wrappers_refuse_non_cuda_tensors(monkeypatch, which):
    class _Lib:
        flash_attention_bwd_dq_f32 = staticmethod(lambda *a: 0)
        flash_attention_bwd_dkv_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    q = torch.empty(1, 1, 4, 8, device="meta")
    lse = torch.empty(1, 1, 4, 1, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        getattr(tfa, which)(q, q, q, None, q, lse, lse)


def test_kernel_source_names_what_it_replaces_and_its_bound():
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "flash_attention.py `_bwd_dq_kernel`" in src
    assert "`_bwd_dkv_kernel`" in src and "Bound:" in src
    assert "flash_attention_bwd" in _build.SOURCES
