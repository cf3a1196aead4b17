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
* A plain tiled version with the fused CUDA kernel's association (one
  64-key tile at a time, dK and dV of the tile from its queries, dQ summed
  over the key tiles in key order onto zeros; under causal, query tiles
  from the diagonal on) gives the reference's Pallas backward in
  interpret mode and ``flash_attention_bwd_reference``: atol 2e-5.
* ``flash_attention_train`` (a ``torch.autograd.Function``) gives the same
  gradients by autograd and under ``torch.func.vjp``.
* The ``flash_attention`` op's flash route (dropout 0) returns the real
  lse in its Lse output, and its grad op, which reads the saved Out and
  Lse, gives the grads of the recompute route (the forward run again)
  exactly and the reference's grad op to 2e-5; the BERT_TINY programs at
  dropout 0 still equal the reference's through ``to_dict()``.
* The fused kernel's wrapper builds or raises and never falls back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.models import bert as jbert
from paddle_tpu.pallas_kernels.flash_attention import (_bwd_pallas,
                                                       _fwd_pallas,
                                                       _ref_attention)
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.utils import unique_name as tun

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


def test_cuda_branch_propagates_build_failure(monkeypatch):
    def broken(name):
        raise RuntimeError("nvcc failed (1) building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    q = torch.empty(1, 1, 4, 8, device="meta")
    lse = torch.empty(1, 1, 4, 1, device="meta")
    before = tfa.flash_attention_bwd_fused.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa.flash_attention_bwd_fused(q, q, q, None, q, lse, lse)
    assert tfa.flash_attention_bwd_fused.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors(monkeypatch):
    class _Lib:
        flash_attention_bwd_f32 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    q = torch.empty(1, 1, 4, 8, device="meta")
    lse = torch.empty(1, 1, 4, 1, device="meta")
    before = tfa.flash_attention_bwd_fused.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa.flash_attention_bwd_fused(q, q, q, None, q, lse, lse)
    assert tfa.flash_attention_bwd_fused.launches == before


# -- the fused kernel's association, in plain torch ---------------------------

TILE = 64     # keys of a CTA's tile and rows of a query tile in the kernel


def _tiled_bwd(q, k, v, bias, do, lse, delta, causal, scale):
    """(dq, dk, dv) as ``csrc/flash_attention_bwd.cu`` associates them:
    each 64-key tile's dK and dV from the query rows it sees (under causal
    from its diagonal tile on), and dQ as zeros plus one term per key tile,
    in key order."""
    sq, sk = q.shape[2], k.shape[2]
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for k0 in range(0, sk, TILE):
        ks, vs = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        r0 = k0 if causal else 0
        qs, dos = q[:, :, r0:], do[:, :, r0:]
        s = torch.einsum("bhqd,bhkd->bhqk", qs, ks) * scale
        if bias is not None:
            s = s + bias[:, :, r0:, k0:k0 + TILE]
        if causal:
            above = torch.arange(k0, k0 + ks.shape[2])[None, :] \
                > torch.arange(r0, sq)[:, None]
            s = s.masked_fill(above, -1e30)
        lr = lse[:, :, r0:]
        p = torch.exp(s - lr)
        p = torch.where(lr < -1e29, p / sk, p)
        dp = torch.einsum("bhqd,bhkd->bhqk", dos, vs)
        ds = p * (dp - delta[:, :, r0:]) * scale
        dq[:, :, r0:] = dq[:, :, r0:] + torch.einsum("bhqk,bhkd->bhqd", ds,
                                                     ks)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qs))
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, dos))
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 256, 64), (2, 3, 128, 64)])
def test_tiled_association_matches_pallas_backward(causal, with_bias, shape):
    """The reference test's shape (four key tiles) and a BERT-like one
    (two key tiles, BERT's S = 128)."""
    rng = np.random.RandomState(4)
    bb, h, s, d = shape
    q, k, v, do = (_rand(rng, bb, h, s, d) for _ in range(4))
    bias = _key_padding(rng, bb, 1, s, s) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    out, lse = _fwd_pallas(q, k, v, jb, causal, d ** -0.5, 128, 128,
                           interpret=True)
    pallas = _bwd_pallas(q, k, v, jb, causal, d ** -0.5, 128, 128, True, out,
                         lse, do)
    tq, tk, tv, tdo, tout, tlse = (_t(a) for a in (q, k, v, do, out, lse))
    got = _tiled_bwd(tq, tk, tv, _t(bias), tdo, tlse,
                     tfa.attention_delta(tout, tdo), causal, d ** -0.5)
    plain = tfa.flash_attention_bwd_reference(tq, tk, tv, _t(bias), tout,
                                              tlse, tdo, causal)
    for name, g, w, pl in zip(("dq", "dk", "dv"), got, pallas, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), pl.numpy(), atol=ATOL, rtol=0,
                                   err_msg=name)


# -- the op: the flash route carries its lse ----------------------------------

def _fa_attrs(causal):
    return {"causal": causal, "scale": 0.0, "layout": "BHSD",
            "dropout_prob": 0.0, "is_test": False}


def _op(pkg, op_type, args, attrs):
    if pkg == "port":
        out = treg.get_op_def(op_type).lower(
            TCtx(torch.device("cpu")),
            *[None if a is None else torch.from_numpy(np.array(a))
              for a in args], **attrs)
    else:
        out = jreg.get_op_def(op_type).lower(
            JCtx(rng_key=jax.random.key(0), mode="eager"),
            *[None if a is None else jnp.asarray(a) for a in args], **attrs)
    return [None if o is None else np.asarray(o) for o in out]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_route_lse_feeds_the_grad_op(causal):
    rng = np.random.RandomState(5)
    bb, h, s, d = 2, 2, 33, 16
    q, k, v, dout = (_rand(rng, bb, h, s, d) for _ in range(4))
    bias = _key_padding(rng, bb, 1, s, s)
    attrs = _fa_attrs(causal)
    fwd = _op("port", "flash_attention", [q, k, v, bias], attrs)
    out, lse = tfa.flash_attention(*(_t(a) for a in (q, k, v, bias)),
                                   causal=causal)
    np.testing.assert_array_equal(fwd[0], out.numpy())
    assert fwd[3].shape == (bb, h, s, 1)
    np.testing.assert_array_equal(fwd[3], lse.numpy())
    out_, mask, seed, lse_ = fwd
    got = _op("port", "flash_attention_grad",
              [q, k, v, bias, mask, out_, seed, lse_, dout], attrs)
    # the recompute route: the forward again for out and lse
    recomputed = tfa.flash_attention_bwd(
        *(_t(a) for a in (q, k, v, bias)), out, lse, _t(dout), causal)
    for g, w in zip(got, recomputed):
        np.testing.assert_array_equal(g, w.numpy())
    jfwd = _op("jax", "flash_attention", [q, k, v, bias], attrs)
    assert jfwd[3].shape == (1, 1, 1, 1)     # the reference's placeholder
    want = _op("jax", "flash_attention_grad",
               [q, k, v, bias, jfwd[1], jfwd[0], jfwd[2], jfwd[3], dout],
               attrs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("which", ["main", "startup"])
def test_bert_tiny_dropout0_programs_equal_reference(which):
    """The Lse var keeps no shape in the desc, so carrying the real lse
    changes no program."""
    progs = []
    for mod, fw, un in ((tbert, tfw, tun), (jbert, fluid, jun)):
        main, startup = fw.Program(), fw.Program()
        with un.guard(), fw.program_guard(main, startup):
            cfg = mod.BertConfig(**dict(vars(mod.BERT_TINY), dropout=0.0))
            mod.build_pretrain(cfg, seq_len=16, lr=1e-3)
        progs.append(main if which == "main" else startup)
    got, want = progs
    assert got.to_dict() == want.to_dict()
    if which == "main":
        ops = got.global_block().ops
        assert [op.type for op in ops].count("flash_attention") == 2
        grads = [op for op in ops if op.type == "flash_attention_grad"]
        assert len(grads) == 2
        assert all(op.input("Lse") for op in grads)


def test_kernel_source_names_what_it_replaces_and_its_bound():
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "flash_attention.py `_bwd_dq_kernel`" in src
    assert "`_bwd_dkv_kernel`" in src and "Bound:" in src
    assert "Five multiply-adds per (i, j, d)" in src
    assert "bitwise reproducible" in src
    assert "flash_attention_bwd" in _build.SOURCES
