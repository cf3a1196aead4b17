"""BERT pretraining at dropout > 0 through the PyTorch port's entry points
(``build_pretrain`` -> ``Executor.run``), held against the JAX package on
the CPU: the slice as a whole.

* Programs: BERT_TINY at its default dropout 0.1 builds main and startup
  programs equal to the reference's through ``to_dict()``, in the default
  emission (embeddings dropout, composed attention with a dropout op) and
  with ``BERT_FUSED_ATTN=1`` (one flash_attention op with in-op dropout
  per layer), read from the environment at build time in both packages.
* Training: the two packages draw from different streams, so both draw
  points of each are patched to one mask, a fixed function of the shape
  and the element index (a multiplicative hash of the index against the
  draw's own threshold): the reference's ``ops.nn.bernoulli_bytes`` and
  ``fused_ln._fallback_keep`` (traced under jit, where the shape is
  static), the port's ``philox.keep_bytes`` and ``philox.keep_mask``
  (drawn eagerly).  From the reference's initial weights, BERT_TINY
  trains 5 Adam steps with the reference's losses to 1e-4 (f32 in
  another summation order, as at dropout 0), in both emissions.
* The small-sequence route: BERT_TINY never reaches it (D = 16, S = 16),
  so a config with hidden 128, 2 heads (D = 64) and seq 128 trains 3
  steps with ``FLAGS_fused_small_attention`` on in the port (the small
  kernels' plain versions, checked to run) against the reference's
  composed in-op route (its CPU route), at p = 0.25, where the byte draw
  and the u32 draw keep with the same probability (0.75); losses to 1e-4.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import nn as jnn
from paddle_tpu.pallas_kernels import fused_ln as jfl
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.utils import unique_name as tun

LOSS_ATOL = 1e-4
LR = 1e-3


def tiny(mod, dropout=0.1):
    return mod.BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                          ffn=128, max_pos=64, dropout=dropout)


def small_route_cfg(mod):
    return mod.BertConfig(vocab_size=1024, hidden=128, layers=2, heads=2,
                          ffn=256, max_pos=128, dropout=0.25)


def programs(mod, fw, un, cfg, seq):
    main, startup = fw.Program(), fw.Program()
    if hasattr(startup, "random_seed"):
        startup.random_seed = 5
    with un.guard(), fw.program_guard(main, startup):
        _inputs, loss = mod.build_pretrain(cfg, seq_len=seq, lr=LR)
    return main, startup, loss


@pytest.mark.parametrize("fused_attn", [False, True])
def test_dropout_programs_equal_reference(monkeypatch, fused_attn):
    if fused_attn:
        monkeypatch.setenv("BERT_FUSED_ATTN", "1")
    else:
        monkeypatch.delenv("BERT_FUSED_ATTN", raising=False)
    jm, js, _ = programs(jbert, fluid, jun, jbert.BERT_TINY, 16)
    tm, ts, _ = programs(tbert, tfw, tun, tbert.BERT_TINY, 16)
    assert tbert.BERT_TINY.dropout == 0.1
    for got, want in ((tm, jm), (ts, js)):
        assert got.to_dict() == want.to_dict()
    types = [op.type for op in tm.global_block().ops]
    if fused_attn:
        assert types.count("flash_attention") == 2
        assert types.count("dropout") == 1
    else:
        assert "flash_attention" not in types
        assert types.count("dropout") == 3       # embeddings + 2 layers
        assert types.count("dropout_grad") == 3


def test_composed_ln_switch_raises(monkeypatch):
    monkeypatch.setenv("BERT_COMPOSED_LN", "1")
    with pytest.raises(NotImplementedError, match="BERT_COMPOSED_LN"):
        programs(tbert, tfw, tun, tbert.BERT_TINY, 16)


def _hash_keep(shape, thr):
    """Keep iff hash(element index) < thr (a u32 threshold): a fixed
    function of the shape and the index, the same traced or eager."""
    n = int(np.prod(shape))
    h = (np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B1)
         + np.uint64(0x7F4A7C15)) & np.uint64(0xFFFFFFFF)
    return (h < np.uint64(thr)).reshape(tuple(int(d) for d in shape))


def patch_masks(monkeypatch):
    """Both packages' draw points -> _hash_keep at each draw's own
    threshold (bytes: round(q 256) / 256 of 2^32)."""
    jax_bytes0, jax_keep0 = jnn.bernoulli_bytes, jfl._fallback_keep

    def static(shape):
        # graph-build shape inference traces with a symbolic batch dim:
        # there the reference's own draw stands (only its shape is read)
        return all(isinstance(d, (int, np.integer)) for d in shape)

    def jax_bytes(key, keep_prob, shape):
        if not static(shape):
            return jax_bytes0(key, keep_prob, shape)
        thr8 = min(max(int(round(float(keep_prob) * 256.0)), 0), 256)
        return _hash_keep(shape, thr8 << 24)

    def jax_keep(seed, thr, shape):
        if not static(shape):
            return jax_keep0(seed, thr, shape)
        return _hash_keep(shape, thr)

    monkeypatch.setattr(jnn, "bernoulli_bytes", jax_bytes)
    monkeypatch.setattr(jfl, "_fallback_keep", jax_keep)
    monkeypatch.setattr(
        philox, "keep_bytes",
        lambda seed, thr, shape, device="cpu": torch.from_numpy(
            _hash_keep(shape, thr << 24)).to(device))
    monkeypatch.setattr(
        philox, "keep_mask",
        lambda seed, thr, shape, device="cpu": torch.from_numpy(
            _hash_keep(shape, thr)).to(device))


def feed(cfg, batch, seq, seed=0):
    """bench.py's _bert_feed with padded tails, so the attention bias
    masks keys."""
    rng = np.random.RandomState(seed)
    f = tbert.pretrain_feed(rng, cfg, batch, seq)
    lens = rng.randint(seq // 2, seq + 1, batch)
    f["input_mask"] = (np.arange(seq)[None, :] < lens[:, None]) \
        .astype(np.float32)[:, :, None]
    return f


def train_both(cfg_of, seq, batch, steps):
    """Losses of ``steps`` steps in each package from the reference's
    initial weights."""
    jm, js, jloss = programs(jbert, fluid, jun, cfg_of(jbert), seq)
    tm, _ts, tloss = programs(tbert, tfw, tun, cfg_of(tbert), seq)
    f = feed(cfg_of(tbert), batch, seq)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars()
             if v.persistable and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}
        want = [float(np.asarray(exe.run(jm, feed=f,
                                         fetch_list=[jloss])[0]).ravel()[0])
                for _ in range(steps)]
    tscope = scope_from_numpy(Scope(), init, "cpu", program=tm)
    texe = Executor(tfw.CPUPlace())
    got = [float(texe.run(tm, feed=f, fetch_list=[tloss],
                          scope=tscope)[0].ravel()[0])
           for _ in range(steps)]
    return got, want


@pytest.mark.parametrize("fused_attn", [False, True])
def test_bert_tiny_at_dropout_trains_as_the_reference(monkeypatch,
                                                      fused_attn):
    if fused_attn:
        monkeypatch.setenv("BERT_FUSED_ATTN", "1")
    else:
        monkeypatch.delenv("BERT_FUSED_ATTN", raising=False)
    patch_masks(monkeypatch)
    got, want = train_both(tiny, 16, 4, 5)
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert got[-1] < got[0]


def test_small_route_trains_as_the_reference_composed_route(monkeypatch):
    monkeypatch.setenv("BERT_FUSED_ATTN", "1")
    monkeypatch.setattr(tflags, "_flags",
                        {"FLAGS_fused_small_attention": True})
    patch_masks(monkeypatch)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.small_attention_fwd_reference, \
        tfa.small_attention_bwd_reference

    def count(name, fn):
        def wrapped(*a, **k):
            # data runs only: build-time shape inference runs on meta
            calls[name] += a[0].device.type == "cpu"
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "small_attention_fwd_reference",
                        count("fwd", fwd))
    monkeypatch.setattr(tfa, "small_attention_bwd_reference",
                        count("bwd", bwd))
    got, want = train_both(small_route_cfg, 128, 2, 3)
    assert calls == {"fwd": 6, "bwd": 6}      # 2 layers x 3 steps
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
