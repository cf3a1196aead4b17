"""The port's decoder (paddle_tpu_torch/serving/decode_model.py) held
against the JAX reference (paddle_tpu/serving/decode_model.py) on the CPU.

Tolerances, all f32: LayerNorm and GELU building blocks 1e-6 (one
op each, another library's rounding); the paged step's logits 1e-5 over a
multi-step feed (two layers of matmuls summed in another order).  Tokens
must be equal.  Within the port on the CPU, paged decode equals unpaged
decode bitwise, as in the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_model as jdm
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.serving import decode_model as tdm

CFGS = {
    "tiny": dict(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48),
    "wide": dict(vocab=61, layers=2, heads=4, head_dim=32, max_seq=64),
}
ATOL_OP = 1e-6
ATOL_LOGITS = 1e-5


def _pair(name, seed=7):
    jcfg = jdm.DecoderConfig(**CFGS[name])
    tcfg = tdm.DecoderConfig(**CFGS[name])
    return jcfg, tcfg, jdm.init_decoder_params(jcfg, seed=seed)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_bitwise_equal_to_reference(name):
    jcfg, tcfg, jp = _pair(name, seed=3)
    tp = tdm.init_decoder_params(tcfg, seed=3)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tp[k].dtype == np.float32 and tp[k].shape == jp[k].shape
        assert np.array_equal(tp[k], jp[k]), k
    assert tcfg.to_dict() == jcfg.to_dict()


def test_layer_norm_and_gelu_match_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(5, 24) * 3 + 1).astype(np.float32)
    g = rng.randn(24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = np.asarray(jdm._ln(x, g, b))
    got = tdm._ln(*[torch.from_numpy(a) for a in (x, g, b)]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_OP)
    # jax.nn.gelu's default is the tanh form; the port asks for it by name
    want = np.asarray(jax.nn.gelu(x))
    got = torch.nn.functional.gelu(torch.from_numpy(x),
                                   approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_OP)


def _feed_plan(maxb, bs):
    """Three lanes over a shuffled pool plus one idle lane, fed for a few
    steps: lane 0 starts fresh, lane 1 sits mid-block, lane 2 crosses a
    block boundary; the tables stay fixed across the feed."""
    tables = np.full((4, maxb), -1, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :3] = [7, 1, 3]
    tables[2, :4] = [4, 8, 6, 10]
    start = np.array([0, 2, bs - 2, 0], np.int32)
    return tables, start


@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_step_logits_match_reference(name):
    jcfg, tcfg, params = _pair(name)
    bs, nb = 4, 12
    maxb = jcfg.max_seq // bs
    kvc = jkv.KVCacheConfig(jcfg.layers, jcfg.heads, jcfg.head_dim, bs, nb)
    jstep = jax.jit(jdm.make_paged_step(jcfg, kvc))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    shape = (jcfg.layers, nb, bs, jcfg.heads, jcfg.head_dim)
    carry = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    dec = tdm.Decoder(tcfg, params, device="cpu")
    kp = torch.zeros(shape)
    vp = torch.zeros(shape)
    tables, pos = _feed_plan(maxb, bs)
    rng = np.random.RandomState(1)
    live = np.array([1, 1, 1, 0], bool)
    for _ in range(7):
        tok = rng.randint(0, jcfg.vocab, 4).astype(np.int32)
        lens = np.where(live, pos + 1, 0).astype(np.int32)
        carry, jn, jl = jstep(carry, jparams, tok, pos, tables, lens)
        tn, tl = dec.paged_step(kp, vp, *[torch.from_numpy(a) for a in
                                          (tok, pos, tables, lens)])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL_LOGITS)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        pos = pos + live.astype(np.int32)
    # the pools hold the same K/V, written in place on the port's side
    np.testing.assert_allclose(kp.numpy(), np.asarray(carry[0]), rtol=0,
                               atol=ATOL_LOGITS)
    np.testing.assert_allclose(vp.numpy(), np.asarray(carry[1]), rtol=0,
                               atol=ATOL_LOGITS)


PROMPTS = ([1], [2, 3, 4], [5, 6, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5])


@pytest.mark.parametrize("name", sorted(CFGS))
def test_unpaged_generate_tokens_match_reference(name):
    jcfg, tcfg, params = _pair(name)
    dec = tdm.Decoder(tcfg, params, device="cpu")
    for prompt in PROMPTS:
        want = jdm.unpaged_generate(jcfg, params, prompt, 8,
                                    pad_len=jcfg.max_seq)
        assert dec.unpaged_generate(prompt, 8) == want, prompt


def test_unpaged_generate_eos_and_logits():
    _, tcfg, params = _pair("tiny")
    dec = tdm.Decoder(tcfg, params, device="cpu")
    full, logits = dec.unpaged_generate([1, 2], 8, return_logits=True)
    assert len(logits) == 8 and logits[0].shape == (tcfg.vocab,)
    assert [int(np.argmax(lg)) for lg in logits] == full
    cut = dec.unpaged_generate([1, 2], 8, eos_id=full[2])
    assert cut == full[:full.index(full[2]) + 1]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_equals_unpaged_bitwise_in_the_port(name):
    _, tcfg, params = _pair(name)
    dec = tdm.Decoder(tcfg, params, device="cpu")
    bs = 4
    maxb = tcfg.max_seq // bs
    nb = maxb + 3
    shape = (tcfg.layers, nb, bs, tcfg.heads, tcfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    table = torch.full((1, maxb), -1, dtype=torch.int32)
    table[0] = torch.from_numpy(
        np.random.RandomState(2).permutation(np.arange(1, nb))[:maxb]
        .astype(np.int32))
    ushape = (tcfg.layers, 1, maxb * bs, tcfg.heads, tcfg.head_dim)
    kc, vc = torch.zeros(ushape), torch.zeros(ushape)
    toks = np.random.RandomState(3).randint(0, tcfg.vocab, 11)
    for p, t in enumerate(toks):
        tok = torch.tensor([t], dtype=torch.int32)
        pos = torch.tensor([p], dtype=torch.int32)
        lens = pos + 1
        pn, pl = dec.paged_step(kp, vp, tok, pos, table, lens)
        un, ul = dec.unpaged_step(kc, vc, tok, pos, lens)
        assert torch.equal(pl, ul) and torch.equal(pn, un), p


def test_reference_save_dir_loads_into_the_port(tmp_path):
    jcfg, tcfg, params = _pair("wide")
    d = jdm.save_decoder(str(tmp_path / "ref"), jcfg, params)
    lcfg, lparams = tdm.load_decoder(d)
    assert lcfg.to_dict() == jcfg.to_dict()
    dec = tdm.Decoder(lcfg, lparams, device="cpu")
    direct = tdm.from_jax_params(
        tcfg, {k: jnp.asarray(v) for k, v in params.items()}, device="cpu")
    prompt = [4, 8, 15, 16, 23, 42]
    got, gl = dec.unpaged_generate(prompt, 5, return_logits=True)
    want, wl = direct.unpaged_generate(prompt, 5, return_logits=True)
    assert got == want
    for a, b in zip(gl, wl):
        assert np.array_equal(a, b)
    jwant, jl = jdm.unpaged_generate(jcfg, params, prompt, 5,
                                     return_logits=True)
    assert got == jwant
    np.testing.assert_allclose(np.stack(gl), np.stack(jl), rtol=0,
                               atol=ATOL_LOGITS)
    # and the port writes the same format back
    d2 = tdm.save_decoder(str(tmp_path / "port"), lcfg, lparams)
    rcfg, rparams = jdm.load_decoder(d2)
    assert rcfg.to_dict() == jcfg.to_dict()
    assert all(np.array_equal(rparams[k], params[k]) for k in params)


def test_decoder_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, params = _pair("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.Decoder(tcfg, params)
