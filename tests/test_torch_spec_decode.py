"""Speculative decode on the port (paddle_tpu_torch/serving/engine.py
``_spec_step_locked``, decode_model.py ``paged_step_multi``,
``draft_rollout``, ``truncate_decoder`` and the draft bundle) held against
the JAX package on the CPU, at the reference tests' toy widths (vocab 31,
2 layers, 2 heads x 8, blocks of 4).

The reference's speculative cases (tests/test_decode_serving.py:428-835)
are posed against the port: greedy accept-longest-prefix must give
exactly the tokens of plain greedy decode (the reference's
``unpaged_generate``) through EOS, join and leave, rollback, sheds,
preemption, prefix-cache hits and the prefill token budget; both pools
must be empty after.  The port's proposed and accepted totals must equal
the reference engine's for the same requests sent one at a time.
Tolerances of the two step functions against the reference's
``make_paged_step_multi`` and ``make_draft_rollout``: tokens equal,
logits 1e-5 (two layers of matmuls summed in another order), pools 1e-6
(the K/V projections, one layer of matmuls)."""

import glob
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.core import tracing as ttr
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      has_draft, init_decoder_params,
                                      load_decoder, load_draft, save_decoder,
                                      truncate_decoder)

CFG = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
PARAMS = init_decoder_params(CFG, seed=7)
DRAFT = truncate_decoder(CFG, PARAMS, layers=1)
JCFG = jdm.DecoderConfig(**CFG.to_dict())
BS = 4
ATOL_LOGITS = 1e-5
ATOL_POOL = 1e-6


def _unpaged(prompt, max_new, eos_id=-1):
    """The reference's plain greedy tokens (no paging, no speculation)."""
    return np.asarray(jdm.unpaged_generate(JCFG, PARAMS, list(prompt),
                                           max_new, eos_id=eos_id),
                      np.int32)


def _spec_engine(kv_blocks=64, buckets="2,4", k=3, **kw):
    kw.setdefault("deadline_ms", 30000.0)
    e = DecodeEngine(buckets=buckets, block_size=BS, device="cpu", **kw)
    e.add_model("toy", (CFG, PARAMS), kv_blocks=kv_blocks, draft=DRAFT,
                speculative_k=k)
    return e.start()


def _pools_empty(e):
    m = e._models["toy"]
    return m.cache.allocator.in_use == 0 and \
        m.draft_cache.allocator.in_use == 0


@pytest.fixture()
def telemetry_on():
    ttm.reset()
    set_flags({"FLAGS_telemetry": True})
    yield
    set_flags({"FLAGS_telemetry": False})
    ttm.reset()


# -- the two step functions against the reference's -------------------------


def _pool_pair(cfg, nb):
    kvc = jkv.KVCacheConfig(cfg.layers, cfg.heads, cfg.head_dim, BS, nb)
    shape = (cfg.layers, nb, BS, cfg.heads, cfg.head_dim)
    carry = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    return kvc, carry, (torch.zeros(shape), torch.zeros(shape))


def _tables(maxb):
    tables = np.full((4, maxb), -1, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :3] = [7, 1, 3]
    tables[2, :4] = [4, 8, 6, 10]
    return tables


def test_paged_step_multi_matches_reference():
    """A verify-shaped call: lanes with 4, 2 and 1 real columns (junk
    first), an idle lane, twice in a row so the second reads the first's
    writes."""
    from paddle_tpu_torch.serving.decode_model import Decoder

    nb, w = 12, 4
    kvc, carry, pools = _pool_pair(CFG, nb)
    jstep = jax.jit(jdm.make_paged_step_multi(JCFG, kvc, w))
    jparams = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    dec = Decoder(CFG, PARAMS, device="cpu")
    tables = _tables(CFG.max_seq // BS)
    rng = np.random.RandomState(3)
    start = np.array([0, 2, 1, 0], np.int32)
    spans = np.array([4, 2, 1, 0])
    for _ in range(2):
        tok = np.zeros((4, w), np.int32)
        pos = np.zeros((4, w), np.int32)
        lens = np.zeros((4, w), np.int32)
        for i in range(4):
            pad = w - spans[i]
            pos[i, :pad] = start[i]
            for j in range(spans[i]):
                pos[i, pad + j] = start[i] + j
                lens[i, pad + j] = start[i] + j + 1
                tok[i, pad + j] = rng.randint(CFG.vocab)
        carry, jn, jl = jstep(carry, jparams, tok, pos, tables, lens)
        tn, tl = dec.paged_step_multi(
            pools, *[torch.from_numpy(a) for a in (tok, pos, tables, lens)])
        live = lens > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=0, atol=ATOL_LOGITS)
        assert np.array_equal(tn.numpy()[live], np.asarray(jn)[live])
        start = start + spans.astype(np.int32)
    for got, want in zip(pools, carry):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_POOL)


def test_draft_rollout_matches_reference():
    """k = 3 chained proposals from the draft, one lane clamped at its
    last reserved position (max_pos), one idle lane."""
    from paddle_tpu_torch.serving.decode_model import Decoder

    dcfg, dparams = DRAFT
    jdcfg = jdm.DecoderConfig(**dcfg.to_dict())
    nb, k = 12, 3
    kvc, carry, pools = _pool_pair(dcfg, nb)
    jroll = jax.jit(jdm.make_draft_rollout(jdcfg, kvc, k))
    jparams = {n: jnp.asarray(v) for n, v in dparams.items()}
    dec = Decoder(dcfg, dparams, device="cpu")
    tables = _tables(dcfg.max_seq // BS)
    tok = np.array([3, 17, 5, 0], np.int32)
    pos = np.array([0, 6, 9, 0], np.int32)
    lens = np.array([1, 7, 10, 0], np.int32)
    max_pos = np.array([40, 40, 10, 0], np.int32)    # lane 2 clamps
    carry, jp = jroll(carry, jparams, tok, pos, tables, lens, max_pos)
    tp = dec.draft_rollout(pools, *[torch.from_numpy(a) for a in
                                    (tok, pos, tables, lens, max_pos)], k)
    assert tp.shape == (4, k)
    assert np.array_equal(tp.numpy()[:3], np.asarray(jp)[:3])
    for got, want in zip(pools, carry):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_POOL)


# -- the reference's speculative cases, posed on the port --------------------


def test_spec_bitwise_parity_and_eos():
    e = _spec_engine()
    try:
        for prompt in ([1], [2, 3, 4], [5, 6, 7, 8, 9]):
            r = e.generate("toy", prompt, max_new_tokens=8)
            assert r.status == "ok", r.error
            np.testing.assert_array_equal(r.outputs["tokens"],
                                          _unpaged(prompt, 8))
        # an EOS inside an accepted run truncates the emission there
        full = _unpaged([1, 2], 8)
        r = e.generate("toy", [1, 2], max_new_tokens=8, eos_id=int(full[2]))
        assert r.status == "ok"
        np.testing.assert_array_equal(r.outputs["tokens"], full[:3])
        assert _pools_empty(e)
    finally:
        e.stop()


def test_spec_equals_the_ports_own_plain_engine():
    """Within the port: speculation on and off emit the same tokens."""
    prompts = ([1], [9, 9, 9, 2], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [30] * 7)
    outs = []
    for k in (3, 0):
        e = _spec_engine(k=k)
        try:
            reqs = [e.submit("toy", p, max_new_tokens=10) for p in prompts]
            outs.append([r.wait(60.0).outputs["tokens"] for r in reqs])
        finally:
            e.stop()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_spec_mixed_join_leave_parity(telemetry_on):
    e = _spec_engine()
    try:
        e.prewarm()
        started = threading.Event()
        ra = e.submit("toy", [1, 2], max_new_tokens=12,
                      on_token=lambda *a: started.set())
        assert started.wait(30.0)
        prompts = [[3], [4, 5, 6], [7, 8, 9, 10, 11]]
        reqs = [e.submit("toy", p, max_new_tokens=6) for p in prompts]
        a = ra.wait(timeout=60.0)
        assert a.status == "ok"
        np.testing.assert_array_equal(a.outputs["tokens"],
                                      _unpaged([1, 2], 12))
        for p, r in zip(prompts, reqs):
            rep = r.wait(timeout=60.0)
            assert rep is not None and rep.status == "ok", p
            np.testing.assert_array_equal(rep.outputs["tokens"],
                                          _unpaged(p, 6))
        prop = ttm.counter_total("spec_tokens_proposed_total")
        acc = ttm.counter_total("spec_tokens_accepted_total")
        assert prop > 0 and 0 < acc <= prop
        assert any(k.startswith("spec_acceptance")
                   for k in ttm.snapshot()["histograms"])
    finally:
        e.stop()


def test_spec_rollback_returns_blocks_same_iteration(telemetry_on):
    """A draft whose head is zero proposes token 0 every time, so the
    target rejects nearly every proposal: the blocks reserved for them go
    back to both pools within the iteration (checked at every step
    boundary), and the tokens stay the plain ones."""
    dcfg, dparams = DRAFT
    wrong = (dcfg, dict(dparams, head=np.zeros_like(dparams["head"])))
    e = DecodeEngine(buckets="2", block_size=BS, device="cpu",
                     deadline_ms=30000.0)
    m = e.add_model("toy", (CFG, PARAMS), kv_blocks=64, draft=wrong,
                    speculative_k=3)
    over = []

    def boundary():
        # the decode thread, between iterations: no live lane holds a
        # block past the one of its last written position
        for s in e._active:
            need = m.cache.blocks_for_tokens(s.n_fed) if s.n_fed else 0
            if len(s.blocks) > need or len(s.draft_blocks) > need:
                over.append((s.n_fed, len(s.blocks), len(s.draft_blocks)))

    e.on_batch_boundary = boundary
    e.start()
    try:
        prompts = ([1, 2, 3], [9, 8, 7, 6])
        reqs = [e.submit("toy", p, max_new_tokens=10) for p in prompts]
        for p, r in zip(prompts, reqs):
            rep = r.wait(timeout=60.0)
            assert rep.status == "ok"
            np.testing.assert_array_equal(rep.outputs["tokens"],
                                          _unpaged(p, 10))
    finally:
        e.stop()
    assert not over
    assert _pools_empty(e)
    assert ttm.counter_total("spec_blocks_rolled_back_total") > 0
    prop = ttm.counter_total("spec_tokens_proposed_total")
    assert prop > 0 and \
        ttm.counter_total("spec_tokens_accepted_total") < prop / 2


def test_spec_shed_mid_decode_keeps_decoding(telemetry_on):
    e = _spec_engine(kv_blocks=10, buckets="1", k=3)
    try:
        deep = threading.Event()

        def on_tok(rid, i, tok, done, st):
            if i >= 20:     # A holds >= 7 of the 9 usable blocks now
                deep.set()

        ra = e.submit("toy", [1] * 5, max_new_tokens=30, on_token=on_tok)
        assert deep.wait(60.0)
        b = e.submit("toy", [2] * 12, max_new_tokens=4).wait(timeout=30.0)
        assert b.status == "shed", b.status
        assert b.retry_after_ms >= 1.0
        assert ttm.counter_total("serving_shed_total") >= 1
        a = ra.wait(timeout=60.0)
        assert a.status == "ok"
        np.testing.assert_array_equal(a.outputs["tokens"],
                                      _unpaged([1] * 5, 30))
    finally:
        e.stop()


def test_spec_preemption_of_speculating_sequence(telemetry_on):
    e = _spec_engine(kv_blocks=4, buckets="2", k=3)
    try:
        with e._cond:       # both admitted at the same iteration boundary
            ra = e.submit("toy", [1, 2, 3, 4], max_new_tokens=8)
            rb = e.submit("toy", [5, 6, 7, 8], max_new_tokens=4)
        a = ra.wait(timeout=60.0)
        b = rb.wait(timeout=60.0)
        assert a is not None and a.status == "ok", a and a.error
        assert b is not None and b.status == "ok", b and b.error
        np.testing.assert_array_equal(a.outputs["tokens"],
                                      _unpaged([1, 2, 3, 4], 8))
        np.testing.assert_array_equal(b.outputs["tokens"],
                                      _unpaged([5, 6, 7, 8], 4))
        assert ttm.counter_total("kv_block_evictions_total") >= 1
        assert e.preemptions >= 1 and _pools_empty(e)
    finally:
        e.stop()


def test_spec_decode_step_span_has_acceptance_attrs(tmp_path):
    set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": str(tmp_path)})
    try:
        e = _spec_engine()
        try:
            r = e.generate("toy", [1, 2, 3], max_new_tokens=8)
            assert r.status == "ok"
        finally:
            e.stop()
        ttr.flush()
        recs = []
        for p in glob.glob(str(tmp_path / "trace-*.jsonl")):
            with open(p) as f:
                recs += [json.loads(line) for line in f if line.strip()]
        spans = [s for s in recs if s.get("t") == "span"]
        steps = [s for s in spans
                 if s.get("name") == "serving.decode_step"
                 and (s.get("attrs") or {}).get("speculative")]
        assert steps, "no speculative decode_step span recorded"
        assert all("k_proposed" in s["attrs"] and "k_accepted" in s["attrs"]
                   for s in steps)
        step_ids = {x.get("sid") for x in steps}
        kids = {s.get("name") for s in spans if s.get("parent") in step_ids}
        assert {"serving.verify", "serving.draft",
                "serving.draft_ingest"} <= kids
        phases = {n.get("phase") for n in recs
                  if n.get("t") == "note" and n.get("kind") == "decode_step"}
        assert {"draft", "verify"} <= phases
    finally:
        ttr.reset()
        set_flags({"FLAGS_tracing": False, "FLAGS_telemetry_dir": ""})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_draft_bundle_roundtrip_across_packages(tmp_path, writer):
    """A bundle written by either package loads into the other; a
    directory source brings its draft, and FLAGS_speculative_k turns
    speculation on without touching the call."""
    d = str(tmp_path / "bundle")
    if writer == "port":
        save_decoder(d, CFG, PARAMS, draft=DRAFT)
        jcfg, jparams = jdm.load_draft(d)
        assert jdm.has_draft(d) and jcfg.layers == 1
        assert sorted(jparams) == sorted(DRAFT[1])
    else:
        jdraft = jdm.truncate_decoder(JCFG, PARAMS, layers=1)
        jdm.save_decoder(d, JCFG, PARAMS, draft=jdraft)
    assert has_draft(d)
    dcfg, dparams = load_draft(d)
    assert dcfg.to_dict() == DRAFT[0].to_dict()
    assert sorted(dparams) == sorted(DRAFT[1])
    for n in dparams:
        np.testing.assert_array_equal(dparams[n], DRAFT[1][n])
    assert load_decoder(d)[0].to_dict() == CFG.to_dict()
    set_flags({"FLAGS_speculative_k": 2})
    try:
        e = DecodeEngine(buckets="1", block_size=BS, device="cpu",
                         deadline_ms=30000.0)
        m = e.add_model("toy", d, kv_blocks=32)
        plain = e.add_model("plain", (CFG, PARAMS), kv_blocks=32)
    finally:
        set_flags({"FLAGS_speculative_k": 0})
    assert m.spec_k == 2 and e.spec("toy")["speculative_k"] == 2
    assert e.spec("toy")["draft"]["layers"] == 1
    # without a draft, k is ignored: the model decodes plain
    assert plain.spec_k == 0 and "draft" not in e.spec("plain")
    e.start()
    try:
        r = e.generate("toy", [3, 1, 4], max_new_tokens=6)
        assert r.status == "ok"
        np.testing.assert_array_equal(r.outputs["tokens"],
                                      _unpaged([3, 1, 4], 6))
    finally:
        e.stop()
    assert load_draft(str(tmp_path)) is None


def test_draft_vocab_and_max_seq_mismatch_rejected(tmp_path):
    bad_cfg = DecoderConfig(vocab=7, layers=1, heads=2, head_dim=8,
                            max_seq=48)
    bad = (bad_cfg, init_decoder_params(bad_cfg, seed=1))
    with pytest.raises(ValueError, match="vocab"):
        save_decoder(str(tmp_path / "x"), CFG, PARAMS, draft=bad)
    e = DecodeEngine(buckets="1", block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        e.add_model("toy", (CFG, PARAMS), kv_blocks=16, draft=bad,
                    speculative_k=2)
    short_cfg = DecoderConfig(vocab=31, layers=1, heads=2, head_dim=8,
                              max_seq=32)
    short = (short_cfg, init_decoder_params(short_cfg, seed=1))
    with pytest.raises(ValueError, match="max_seq"):
        e.add_model("toy", (CFG, PARAMS), kv_blocks=16, draft=short,
                    speculative_k=2)


def test_spec_prefix_cache_hit_parity(telemetry_on):
    e = _spec_engine()
    try:
        prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]
        want = _unpaged(prompt, 8)
        for i, want_cached in enumerate((0, 8)):
            r = e.generate("toy", prompt, max_new_tokens=8)
            assert r.status == "ok", (i, r.error)
            assert r.phases["cached_tokens"] == want_cached
            np.testing.assert_array_equal(r.outputs["tokens"], want)
        m = e._models["toy"]
        assert _pools_empty(e)
        # the draft pool never holds published blocks
        assert m.draft_cache.allocator.num_evictable == 0
    finally:
        e.stop()


def test_prefill_token_budget_spec_parity():
    """Prefill chunks are capped by the budget, decode lanes keep
    speculating, every stream keeps the plain tokens."""
    e = _spec_engine(buckets="2,4", prefill_token_budget=3)
    try:
        prompts = [[t] * 16 for t in (9, 8, 7)]
        with e._cond:
            reqs = [e.submit("toy", p, max_new_tokens=5) for p in prompts]
        for p, r in zip(prompts, reqs):
            rep = r.wait(timeout=60.0)
            assert rep is not None and rep.status == "ok", p[0]
            np.testing.assert_array_equal(rep.outputs["tokens"],
                                          _unpaged(p, 5))
        assert _pools_empty(e)
    finally:
        e.stop()


def test_plan_caps_prefill_spans_to_the_budget():
    e = DecodeEngine(buckets="4", block_size=BS, device="cpu",
                     prefill_token_budget=5)
    e.add_model("toy", (CFG, PARAMS), kv_blocks=32, draft=DRAFT,
                speculative_k=3)

    class _S:
        handoff = False         # not a prefill-role sequence

        def __init__(self, n_fed, upto):
            self.n_fed, self.replay_upto = n_fed, upto

        @property
        def in_prefill(self):
            return self.n_fed < self.replay_upto

    lanes = [_S(10, 10), _S(0, 16), _S(0, 2), _S(0, 16)]
    e._active = lanes
    # decode lanes always; prefill lanes until 5 tokens: 4 (a chunk of
    # k + 1), then the 1 left
    got, caps = e._plan_lanes_locked(4)
    assert got == lanes[:3]
    assert caps == {id(lanes[1]): 4, id(lanes[2]): 1}
    # the next iteration starts the rotation past them, one token a lane
    got, caps = e._plan_lanes_locked(1)
    assert got == [lanes[0], lanes[3], lanes[1], lanes[2]]
    assert caps == {id(s): 1 for s in lanes[1:]}


# -- acceptance against the reference engine ---------------------------------


def test_spec_totals_equal_the_reference_engines(telemetry_on):
    """The same prompts, one request at a time, through the reference's
    speculative engine and the port's: the proposed and accepted totals
    and the tokens are equal."""
    prompts = ([1], [2, 3, 4], [3, 1, 4, 1, 5, 9, 2, 6, 5], [17] * 6)
    old = fluid.get_flags(["FLAGS_kv_block_size", "FLAGS_telemetry"])
    fluid.set_flags({"FLAGS_kv_block_size": BS, "FLAGS_telemetry": True})
    jtm.reset()
    try:
        ref = JDecodeEngine(buckets="1", deadline_ms=30000.0)
        ref.add_model("toy", (JCFG, PARAMS), kv_blocks=64,
                      draft=jdm.truncate_decoder(JCFG, PARAMS, layers=1),
                      speculative_k=3)
        ref.start()
        try:
            want = [ref.generate("toy", p, max_new_tokens=10,
                                 deadline_ms=30000.0) for p in prompts]
        finally:
            ref.stop()
        want_totals = [jtm.counter_total(n) for n in (
            "spec_tokens_proposed_total", "spec_tokens_accepted_total")]
    finally:
        fluid.set_flags(old)
        jtm.reset()
    e = _spec_engine(buckets="1")
    try:
        got = [e.generate("toy", p, max_new_tokens=10) for p in prompts]
    finally:
        e.stop()
    for r, w in zip(got, want):
        assert r.status == w.status == "ok"
        np.testing.assert_array_equal(r.outputs["tokens"],
                                      w.outputs["tokens"])
    got_totals = [ttm.counter_total(n) for n in (
        "spec_tokens_proposed_total", "spec_tokens_accepted_total")]
    assert got_totals == want_totals and want_totals[0] > 0


def test_spec_counts_and_prewarm_manifest():
    """The model entry counts its verify, rollout and ingest calls;
    prewarm runs each once per lane bucket and names them."""
    e = DecodeEngine(buckets="2,4", block_size=BS, device="cpu",
                     deadline_ms=30000.0)
    m = e.add_model("toy", (CFG, PARAMS), kv_blocks=32, draft=DRAFT,
                    speculative_k=3)
    man = e.prewarm()["toy"]
    assert sorted(man) == [2, 4]
    assert sorted(man[2]) == ["draft_ingest", "draft_rollout", "verify"]
    assert all(v["source"] == "compiled" for v in man[4].values())
    assert e.prewarm()["toy"][2]["verify"]["source"] == "memory"
    v0, r0, i0 = m.verifies, m.rollouts, m.ingests
    e.start()
    try:
        assert e.generate("toy", [4, 5, 6, 7, 8, 9], max_new_tokens=8) \
            .status == "ok"
    finally:
        e.stop()
    # one verify an iteration; a rollout once a lane generates
    assert m.verifies - v0 == e.steps and 0 < m.rollouts - r0 < e.steps
    assert m.ingests - i0 >= 2       # the prompt's two chunks at least
    assert _pools_empty(e)
