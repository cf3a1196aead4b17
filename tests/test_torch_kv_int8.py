"""Int8 KV residency of the port (paddle_tpu_torch/serving/kv_cache.py,
decode_model.py, engine.py and kernels/paged_attention.py) held against
the JAX package's on the CPU.

Tolerances: ``quantize_kv`` payload and scales bitwise against the
reference run op by op (both divide by the same f32 scale and round half
to even).  Two exceptions, both in the scales: under ``jax.jit`` XLA
turns ``max|x| / 127`` into a multiply by 1/127, which moves a scale by
up to one ulp (the payload stays bitwise); and in the decode step the
K/V being quantized come from two libraries' f32 projections, which
agree to about 1e-7, so the step's scales are held to 1e-6 relative
while its payload stays bitwise.  The int8 attention's plain version
1e-6 of the reference's gather, dequantize and ``masked_attention``
(another library's f32 einsum and softmax); the int8 ``paged_step``
logits 1e-5 over 8 steps (two layers of matmuls summed in another
order); an int8 engine's tokens equal to the reference int8 engine's.
Host logic (sizing, trim_table) exactly."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.pallas_kernels import paged_attention as jpa
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving import decode_model as tdm
from paddle_tpu_torch.serving import kv_cache as tkv

CFG = dict(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
BS = 4
ATOL_ATTN = 1e-6
ATOL_LOGITS = 1e-5


def _cfg(mod, **kw):
    base = dict(layers=2, heads=2, head_dim=8, block_size=4, num_blocks=8)
    base.update(kw)
    return mod.KVCacheConfig(**base)


# -- quantize_kv -------------------------------------------------------------


def _kv_rows(seed, scale):
    """Random rows with the edge cases: an all-zero row, exact halves after
    the division, and the row maximum at both signs."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(6, 5, 3, 16) * scale).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 0, 0, :5] = [0.5, 1.5, -2.5, 127.0, -127.0]
    x[1, 0, 0, 5:] = 0.0
    x[2, 1, 2] = -x[2, 1, 2]
    return x


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 40.0),
                                        (3, 1e-30)])
def test_quantize_kv_bitwise_the_reference(seed, scale):
    x = _kv_rows(seed, scale)
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # jitted, XLA multiplies by 1/127: a scale may move by one ulp
    jq2, js2 = jax.jit(jkv.quantize_kv)(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq2))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js2), maxulp=1)
    back = tkv.dequantize_kv(tq, ts).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jkv.dequantize_kv(jq, js)))
    # symmetric max-abs: the error is at most half a step
    assert np.all(np.abs(back - x) <= ts.numpy()[..., None] * 0.5 + 1e-7)


def test_quantize_all_zero_is_safe():
    q, s = tkv.quantize_kv(torch.zeros(2, 4, 2, 8))
    assert not torch.isnan(s).any() and not q.any()
    assert not tkv.dequantize_kv(q, s).any()


# -- sizing and the pools ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_block_bytes_match_reference(dtype):
    assert tkv.block_bytes(_cfg(tkv, dtype=dtype)) == \
        jkv.block_bytes(_cfg(jkv, dtype=dtype))


def test_block_bytes_int8_counts_payload_and_scales():
    i8 = tkv.block_bytes(_cfg(tkv, dtype="int8"))
    assert i8 == 2 * 2 * 4 * (2 * 8 * 1 + 2 * 4)
    assert i8 < tkv.block_bytes(_cfg(tkv)) / 2


def test_config_refuses_other_dtypes():
    for mod in (tkv, jkv):
        with pytest.raises(ValueError, match="f32|int8"):
            _cfg(mod, dtype="bf16")


def test_plan_message_names_the_int8_residency():
    cfg = _cfg(tkv)
    with pytest.raises(ValueError, match="FLAGS_kv_cache_dtype=int8"):
        tkv.plan_num_blocks(cfg, requested=8, budget=tkv.block_bytes(cfg))


def test_int8_cache_pools_shapes_and_types():
    c = tkv.PagedKVCache(_cfg(tkv, dtype="int8"), device="cpu")
    k, v, ks, vs = c.pools
    jc = jkv.PagedKVCache(_cfg(jkv, dtype="int8"))
    for got, want in zip(c.pools, jc.carry()):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert c.nbytes == jc.nbytes
    assert len(tkv.PagedKVCache(_cfg(tkv), device="cpu").pools) == 2


def _trim_script(mod, cache):
    table = np.full(8, -1, np.int32)
    blocks = []
    trace = [cache.ensure_table(table, blocks, 16), list(blocks)]
    trace += [cache.trim_table(table, blocks, 6), list(blocks),
              table.tolist(), cache.allocator.stats()]
    trace += [cache.trim_table(table, blocks, 6),
              cache.ensure_table(table, blocks, 12), list(blocks)]
    trace += [cache.trim_table(table, blocks, 0), table.tolist(),
              cache.allocator.stats()]
    return trace


def test_trim_table_matches_reference():
    """tests/test_kv_cache.py:431 and the LIFO reuse after it, as one
    scripted run on both caches."""
    got = _trim_script(tkv, tkv.PagedKVCache(_cfg(tkv), device="cpu"))
    want = _trim_script(jkv, jkv.PagedKVCache(_cfg(jkv)))
    assert got == want
    assert got[2] == 2 and got[-1]["in_use"] == 0


# -- the int8 attention ------------------------------------------------------


@pytest.mark.parametrize("lens", [[1, 7, 33, 0], [16, 16, 16, 16],
                                  [4, 0, 0, 28]])
def test_int8_attention_plain_matches_reference(lens):
    rng = np.random.RandomState(5)
    bb, h, d, bs, maxb, nb = 4, 3, 8, 4, 8, 20
    q = rng.randn(bb, h, d).astype(np.float32)
    k = rng.randn(nb, bs, h, d).astype(np.float32)
    v = rng.randn(nb, bs, h, d).astype(np.float32)
    tables = np.full((bb, maxb), -1, np.int32)
    tables[:, :] = rng.permutation(np.arange(1, nb))[:maxb]
    lens = np.asarray(lens, np.int32)
    kq, ks = jkv.quantize_kv(jnp.asarray(k))
    vq, vs = jkv.quantize_kv(jnp.asarray(v))
    idx = jnp.maximum(jnp.asarray(tables), 0)
    kk = jkv.dequantize_kv(jnp.take(kq, idx, axis=0),
                           jnp.take(ks, idx, axis=0))
    vv = jkv.dequantize_kv(jnp.take(vq, idx, axis=0),
                           jnp.take(vs, idx, axis=0))
    want = jpa.masked_attention(jnp.asarray(q),
                                kk.reshape(bb, maxb * bs, h, d),
                                vv.reshape(bb, maxb * bs, h, d),
                                jnp.asarray(lens))
    t = torch.from_numpy
    n0 = tpa.paged_attention_int8.launches
    got = tpa.paged_attention_int8(
        t(q), t(np.array(kq)), t(np.array(vq)), t(np.array(ks)),
        t(np.array(vs)), t(tables), t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ATTN)
    # the CPU takes the plain version: no launch counted
    assert tpa.paged_attention_int8.launches == n0


def _meta_int8(bb=2, h=2, d=8, nb=4, bs=4, maxb=3, pool=torch.int8):
    m = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
        *s, dtype=dt, device="meta")
    return (m(bb, h, d), m(nb, bs, h, d, dt=pool), m(nb, bs, h, d, dt=pool),
            m(nb, bs, h), m(nb, bs, h), m(bb, maxb, dt=torch.int32),
            m(bb, dt=torch.int32))


def test_int8_non_cpu_branch_propagates_build_failure(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: a failed build
    surfaces as the error, with no fallback to the plain version."""
    def broken(name):
        raise RuntimeError("nvcc failed building %s" % name)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", broken)
    n0 = tpa.paged_attention_int8.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tpa.paged_attention_int8(*_meta_int8())
    assert tpa.paged_attention_int8.launches == n0


@pytest.mark.parametrize("pool,match", [(torch.int8, "not a CUDA device"),
                                        (torch.float32, "not a CUDA")])
def test_int8_kernel_wrapper_refuses_what_it_does_not_take(monkeypatch, pool,
                                                          match):
    class _Lib:
        paged_attention_int8 = staticmethod(lambda *a: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    n0 = tpa.paged_attention_int8.launches
    with pytest.raises(ValueError, match=match):
        tpa.paged_attention_int8(*_meta_int8(pool=pool))
    assert tpa.paged_attention_int8.launches == n0


def test_int8_wrapper_types_every_argument_of_the_c_entry(monkeypatch):
    """The ctypes types of ``paged_attention_int8`` are the C entry's
    parameters, one for one: ten pointers, eight ints, the float scale,
    the stream."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    decl = re.search(r'extern "C" cudaError_t paged_attention_int8\((.*?)\)',
                     src, re.S).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
            else kinds[p.split()[-2]] for p in decl.split(",")]

    class _Lib:
        paged_attention_int8 = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "load", lambda name: _Lib())
    assert len(want) == 20
    assert list(tpa._kernel_int8().argtypes) == want


def test_int8_launch_hands_the_pools_and_scales_in_the_c_order(monkeypatch):
    """q, k, v, k_scale, v_scale, tables, lens, out, part, count, then the
    geometry: what the wrapper hands the C entry for meta tensors (the
    host reads no length), and one launch counted."""
    calls = []

    class _Stream:
        cuda_stream = 0

    def fake(*a):
        calls.append(a)
        return 0

    monkeypatch.setattr(tpa, "_kernel_int8", lambda: fake)
    monkeypatch.setattr(tpa, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(tpa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    args = _meta_int8(bb=8, h=12, d=64, nb=520, bs=16, maxb=64)
    n0 = tpa.paged_attention_int8.launches
    tpa.paged_attention_int8(*args)
    a, = calls
    assert a[:7] == tuple(t.data_ptr() for t in args)
    assert a[10:16] == (8, 12, 64, 520, 16, 64)
    assert (a[16], a[17]) == tpa.context_splits(64 * 16, 132) == (128, 8)
    assert a[8] is not None and a[9] is not None   # split: scratch, counts
    assert a[18] == pytest.approx(1 / 8.0)
    assert tpa.paged_attention_int8.launches == n0 + 1


# -- the int8 step -----------------------------------------------------------


def test_int8_paged_step_matches_reference_8_steps():
    jcfg = jdm.DecoderConfig(**CFG)
    tcfg = tdm.DecoderConfig(**CFG)
    params = jdm.init_decoder_params(jcfg, seed=7)
    nb = 12
    maxb = jcfg.max_seq // BS
    jkc = jkv.KVCacheConfig(jcfg.layers, jcfg.heads, jcfg.head_dim, BS, nb,
                            dtype="int8")
    jstep = jax.jit(jdm.make_paged_step(jcfg, jkc))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    carry = jkv.PagedKVCache(jkc).carry()
    dec = tdm.Decoder(tcfg, params, device="cpu")
    pools = tkv.PagedKVCache(_cfg(tkv, num_blocks=nb, dtype="int8"),
                             device="cpu").pools
    tables = np.full((4, maxb), -1, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :3] = [7, 1, 3]
    tables[2, :4] = [4, 8, 6, 10]
    pos = np.array([0, 2, BS - 2, 0], np.int32)
    live = np.array([1, 1, 1, 0], bool)
    rng = np.random.RandomState(1)
    for _ in range(8):
        tok = rng.randint(0, jcfg.vocab, 4).astype(np.int32)
        lens = np.where(live, pos + 1, 0).astype(np.int32)
        carry, jn, jl = jstep(carry, jparams, tok, pos, tables, lens)
        tn, tl = dec.paged_step(
            pools[0], pools[1],
            *[torch.from_numpy(a) for a in (tok, pos, tables, lens)],
            scales=pools[2:])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL_LOGITS)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        pos = pos + live.astype(np.int32)
    # the payload bitwise; the scales to 1e-6 relative, their K/V being
    # two libraries' f32 projections (the module docstring)
    for got, want in zip(pools[:2], carry[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(pools[2:], carry[2:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


# -- the int8 engine ---------------------------------------------------------

PROMPTS = ([1], [2, 3, 4], [5, 6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5])


def _reference_int8_tokens(cfg, params, prompts, max_new):
    old = jflags.get_flags(["FLAGS_kv_cache_dtype", "FLAGS_kv_block_size"])
    jflags.set_flags({"FLAGS_kv_cache_dtype": "int8",
                      "FLAGS_kv_block_size": BS})
    try:
        e = JDecodeEngine(buckets="4", deadline_ms=30000.0)
        e.add_model("toy", (cfg, params), kv_blocks=64)
    finally:
        jflags.set_flags(old)
    e.start()
    try:
        reqs = [e.submit("toy", p, max_new_tokens=max_new,
                         deadline_ms=30000.0) for p in prompts]
        return [np.asarray(r.wait(60.0).outputs["tokens"]) for r in reqs]
    finally:
        e.stop()


def test_int8_engine_tokens_equal_the_reference_int8_engine():
    jcfg = jdm.DecoderConfig(**CFG)
    params = jdm.init_decoder_params(jcfg, seed=7)
    want = _reference_int8_tokens(jcfg, params, PROMPTS, 8)
    old = tflags.get_flags("FLAGS_kv_cache_dtype")
    tflags.set_flags({"FLAGS_kv_cache_dtype": "int8"})
    try:
        # kv_dtype None reads the flag, as the reference's engine does
        e = DecodeEngine(buckets="4", block_size=BS, device="cpu",
                         deadline_ms=30000.0)
    finally:
        tflags.set_flags(old)
    m = e.add_model("toy", (tdm.DecoderConfig(**CFG), params), kv_blocks=64)
    assert e.spec("toy")["kv_dtype"] == "int8" and len(m.cache.pools) == 4
    e.start()
    try:
        reqs = [e.submit("toy", p, max_new_tokens=8) for p in PROMPTS]
        got = [r.wait(60.0) for r in reqs]
    finally:
        e.stop()
    for p, r, w in zip(PROMPTS, got, want):
        assert r.status == "ok", r.error
        np.testing.assert_array_equal(r.outputs["tokens"], w, err_msg=p)
    assert m.cache.allocator.in_use == 0


def test_engine_refuses_an_unknown_kv_dtype():
    with pytest.raises(ValueError, match="f32|int8"):
        DecodeEngine(device="cpu", kv_dtype="fp8")
