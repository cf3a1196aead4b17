"""The port's DecodeEngine (paddle_tpu_torch/serving/engine.py) on
``device="cpu"``, held against the JAX reference's greedy
``unpaged_generate``: every request's tokens must be EQUAL to the
reference's (greedy argmax over f32 logits that agree to 1e-5, see
test_torch_decode_model.py), through continuous batching, prefix-cache
hits, preemption and recompute, and the prefill token budget.  Also the
admission rules: validation errors, KV-pressure and queue-full sheds with
retry hints, deadlines in the queue and mid-decode, abort, drain."""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_model as jdm
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      init_decoder_params, save_decoder)

CFG = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
PARAMS = init_decoder_params(CFG, seed=7)
WIDE = DecoderConfig(vocab=61, layers=2, heads=4, head_dim=32, max_seq=64)
WIDE_PARAMS = init_decoder_params(WIDE, seed=5)
BS = 4                      # block size of every engine here


@functools.lru_cache(maxsize=None)
def _ref(prompt, max_new, wide=False, eos_id=-1):
    """The JAX reference's greedy tokens for ``prompt`` (a tuple)."""
    cfg, params = (WIDE, WIDE_PARAMS) if wide else (CFG, PARAMS)
    jcfg = jdm.DecoderConfig(**cfg.to_dict())
    return np.asarray(jdm.unpaged_generate(jcfg, params, list(prompt),
                                           max_new, eos_id=eos_id),
                      np.int32)


def _ref_of(prompt, max_new, **kw):
    return _ref(tuple(prompt), max_new, **kw)


def _mkengine(kv_blocks=64, buckets="2,4", source=(CFG, PARAMS), **kw):
    kw.setdefault("deadline_ms", 30000.0)
    e = DecodeEngine(buckets=buckets, block_size=BS, device="cpu", **kw)
    e.add_model("toy", source, kv_blocks=kv_blocks)
    return e.start()


@pytest.fixture(scope="module")
def eng():
    e = _mkengine()
    yield e
    e.stop()


def _in_use(e):
    return e._models["toy"].cache.allocator.in_use


def _wait_free(e, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and _in_use(e):
        time.sleep(0.01)
    return _in_use(e)


# -- parity with the reference -----------------------------------------------


@pytest.mark.parametrize("buckets", ["1", "2,4"])
def test_tokens_match_reference_unpaged(buckets):
    e = _mkengine(buckets=buckets)
    try:
        for prompt in ([1], [2, 3, 4], [5, 6, 7, 8, 9],
                       [3, 1, 4, 1, 5, 9, 2, 6, 5]):
            r = e.generate("toy", prompt, max_new_tokens=8)
            assert r.status == "ok", r.error
            assert np.array_equal(r.outputs["tokens"], _ref_of(prompt, 8))
            assert r.phases["prompt_tokens"] == len(prompt)
    finally:
        e.stop()


def test_wider_config_matches_reference():
    e = _mkengine(source=(WIDE, WIDE_PARAMS))
    try:
        prompts = ([7], [1, 2, 3, 4, 5, 6], [60, 0, 30, 12, 9, 9, 9, 2, 4])
        reqs = [e.submit("toy", p, max_new_tokens=10) for p in prompts]
        for p, r in zip(prompts, reqs):
            rep = r.wait(timeout=60.0)
            assert rep.status == "ok", rep.error
            assert np.array_equal(rep.outputs["tokens"],
                                  _ref_of(p, 10, wide=True)), p
    finally:
        e.stop()


def test_eos_stops_early(eng):
    full = _ref_of([1, 2], 8)
    eos = int(full[2])
    r = eng.generate("toy", [1, 2], max_new_tokens=8, eos_id=eos)
    assert r.status == "ok"
    want = full[:list(full).index(eos) + 1]
    assert np.array_equal(r.outputs["tokens"], want)
    assert np.array_equal(want, _ref_of([1, 2], 8, eos_id=eos))


def test_mixed_lengths_batch_and_same_step_free(eng):
    prompts = [[1], [2, 3, 4], [5, 6], [7, 8, 9, 10, 11], [12] * 9]
    reqs = [eng.submit("toy", p, max_new_tokens=6) for p in prompts]
    replies = [r.wait(timeout=60.0) for r in reqs]
    assert all(r is not None and r.status == "ok" for r in replies)
    for p, r in zip(prompts, replies):
        assert np.array_equal(r.outputs["tokens"], _ref_of(p, 6)), p
    # every sequence finished: its blocks went back the step it finished
    assert _wait_free(eng) == 0


def test_streaming_phases_and_on_token(eng):
    got = []
    r = eng.generate("toy", [4, 5], max_new_tokens=5,
                     on_token=lambda rid, i, tok, done, st:
                     got.append((i, tok, done, st)))
    assert r.status == "ok"
    assert [g[0] for g in got] == list(range(5))
    assert [g[1] for g in got] == list(r.outputs["tokens"])
    assert got[-1][2] is True and all(g[3] == "ok" for g in got)
    assert r.phases["tokens"] == 5 and r.phases["ttft_ms"] > 0
    assert len(r.phases["itl_ms_samples"]) == 4
    assert r.phases["queue_wait_ms"] >= 0
    assert r.phases["cached_tokens"] == 0


def test_join_and_leave_mid_batch(eng):
    """B is submitted from A's first-token callback, which runs on the
    decode loop between steps: B joins the running batch and leaves it
    while A keeps decoding."""
    order = []
    late = []

    def on_a(rid, i, tok, done, st):
        if i == 0:
            late.append(eng.submit("toy", [3], max_new_tokens=2,
                                   callback=lambda r: order.append("B")))

    ra = eng.submit("toy", [1, 2], max_new_tokens=40,
                    callback=lambda r: order.append("A"), on_token=on_a)
    a = ra.wait(timeout=60.0)
    b = late[0].wait(timeout=60.0)
    assert a.status == "ok" and b.status == "ok"
    assert order == ["B", "A"]
    assert np.array_equal(a.outputs["tokens"], _ref_of([1, 2], 40))
    assert np.array_equal(b.outputs["tokens"], _ref_of([3], 2))


def test_submit_does_not_wait_behind_a_device_step(monkeypatch):
    """A submit() from another thread completes while the loop is inside
    a device step: the step lock is released around the step, so callers
    are never starved by a loop that re-takes it step after step."""
    e = _mkengine()
    dec = e._models["toy"].decoder
    step = dec.paged_step
    seen = []

    def probing(*a):
        if not seen:
            th = threading.Thread(target=lambda: seen.append(
                e.submit("toy", [3], max_new_tokens=2)))
            th.start()
            th.join(5.0)
            seen.append(not th.is_alive())
        return step(*a)

    monkeypatch.setattr(dec, "paged_step", probing)
    try:
        first = e.generate("toy", [1, 2], max_new_tokens=3)
        assert first.status == "ok"
        late, finished_during_step = seen
        assert finished_during_step
        r = late.wait(timeout=60.0)
        assert r.status == "ok"
        assert np.array_equal(r.outputs["tokens"], _ref_of([3], 2))
    finally:
        e.stop()


def test_request_mode_matches_reference():
    e = _mkengine(mode="request")
    try:
        prompts = ([1, 2], [6, 5, 4], [9])
        reqs = [e.submit("toy", p, max_new_tokens=5) for p in prompts]
        for p, r in zip(prompts, reqs):
            rep = r.wait(timeout=60.0)
            assert rep.status == "ok"
            assert np.array_equal(rep.outputs["tokens"], _ref_of(p, 5))
    finally:
        e.stop()


# -- admission ---------------------------------------------------------------


def test_submit_validation_errors(eng):
    assert eng.generate("nope", [1]).status == "error"
    assert eng.generate("toy", []).status == "error"
    r = eng.generate("toy", [1], max_new_tokens=99)
    assert r.status == "error" and "max_seq" in r.error
    assert eng.generate("toy", [31]).status == "error"
    assert eng.generate("toy", [-1]).status == "error"
    stopped = DecodeEngine(block_size=BS, device="cpu")
    stopped.add_model("toy", (CFG, PARAMS))
    assert "not running" in stopped.generate("toy", [1]).error


def test_kv_pressure_sheds_with_retry_hint():
    e = _mkengine(kv_blocks=3, buckets="1")    # capacity 2 beside scratch
    try:
        # a sequence needing more blocks than the pool holds is an error,
        # not a shed: retrying could never admit it
        r = e.generate("toy", [1] * 9, max_new_tokens=8)
        assert r.status == "error" and "pool holds" in r.error
        # under the lock: A's promised prompt blocks plus B's exceed the
        # pool, so B sheds at admission with a drain-time hint
        with e._cond:
            ra = e.submit("toy", [1] * 5, max_new_tokens=3)
            rb = e.submit("toy", [2] * 4, max_new_tokens=4)
        assert rb.reply.status == "shed" and "KV pool" in rb.reply.error
        assert rb.reply.retry_after_ms >= 1.0
        a = ra.wait(timeout=60.0)
        assert a.status == "ok"
        assert np.array_equal(a.outputs["tokens"], _ref_of([1] * 5, 3))
    finally:
        e.stop()


def test_queue_full_sheds():
    e = _mkengine(max_queue=1)
    try:
        with e._cond:
            r1 = e.submit("toy", [1], max_new_tokens=2)
            r2 = e.submit("toy", [2], max_new_tokens=2)
            assert r2.reply.status == "shed"
            assert "queue full" in r2.reply.error
            assert r2.reply.retry_after_ms >= 1.0
        assert r1.wait(timeout=60.0).status == "ok"
    finally:
        e.stop()


def test_deadline_expires_in_queue_and_mid_decode():
    e = _mkengine()
    try:
        with e._cond:          # the loop cannot admit it before expiry
            rq = e.submit("toy", [1, 2], max_new_tokens=4, deadline_ms=1.0)
            time.sleep(0.01)
        r = rq.wait(timeout=10.0)
        assert r.status == "timeout" and "in queue" in r.error

        def stall(rid, i, tok, done, st):
            if i == 0:         # on the loop, between steps: outlive it
                time.sleep(1.2)

        ra = e.submit("toy", [1, 2], max_new_tokens=40, deadline_ms=1000.0,
                      on_token=stall)
        r = ra.wait(timeout=10.0)
        assert r.status == "timeout" and "mid-decode" in r.error
        assert r.phases["tokens"] == 1
        assert _wait_free(e) == 0
    finally:
        e.stop()


def test_abort_queued_and_active(eng):
    with eng._cond:
        rq = eng.submit("toy", [1], max_new_tokens=4)
        assert eng.abort(rq.req_id)
    assert rq.wait(timeout=10.0).status == "aborted"
    aborted = []

    def on_tok(rid, i, tok, done, st):
        if i == 2:             # mid-decode, from the loop's callback
            aborted.append(eng.abort(rid))

    ra = eng.submit("toy", [1, 2], max_new_tokens=40, on_token=on_tok)
    r = ra.wait(timeout=10.0)
    assert aborted == [True] and r.status == "aborted"
    assert _wait_free(eng) == 0
    assert not eng.abort("no-such-request")


def test_preemption_recompute_matches_reference():
    # capacity 3: A wants 3 blocks (12 tokens), B wants 2 (8 tokens) —
    # 5 > 3 forces mid-decode preemption; greedy recompute must re-emit
    # the reference's tokens
    e = _mkengine(kv_blocks=4, buckets="2")
    try:
        with e._cond:       # both admitted at the same iteration boundary
            ra = e.submit("toy", [1, 2, 3, 4], max_new_tokens=8)
            rb = e.submit("toy", [5, 6, 7, 8], max_new_tokens=4)
        a = ra.wait(timeout=60.0)
        b = rb.wait(timeout=60.0)
        assert a is not None and a.status == "ok", a and a.error
        assert b is not None and b.status == "ok", b and b.error
        assert np.array_equal(a.outputs["tokens"], _ref_of([1, 2, 3, 4], 8))
        assert np.array_equal(b.outputs["tokens"], _ref_of([5, 6, 7, 8], 4))
        assert e.preemptions >= 1
        assert _wait_free(e) == 0
    finally:
        e.stop()


# -- prefix cache and prefill budget -----------------------------------------


def test_prefix_cache_hit_equal_outputs():
    e = _mkengine()
    try:
        assert e._models["toy"].prefix is not None
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]      # 11 tokens
        want = _ref_of(prompt, 8)
        r1 = e.generate("toy", prompt, max_new_tokens=8)
        assert r1.status == "ok" and r1.phases["cached_tokens"] == 0
        assert np.array_equal(r1.outputs["tokens"], want)
        # 2 prompt blocks ((11 - 1) // 4) and 2 history blocks: session
        # migration publishes the prompt ++ out chain too (18 fed // 4)
        assert len(e._models["toy"].prefix) == 4
        # the repeat skips both cached full prompt blocks
        r2 = e.generate("toy", prompt, max_new_tokens=8)
        assert r2.status == "ok" and r2.phases["cached_tokens"] == 8
        assert np.array_equal(r2.outputs["tokens"], want)
        # shared prefix, different tail: still a hit, still equal
        p3 = prompt[:8] + [7, 7]
        r3 = e.generate("toy", p3, max_new_tokens=8)
        assert r3.status == "ok" and r3.phases["cached_tokens"] == 8
        assert np.array_equal(r3.outputs["tokens"], _ref_of(p3, 8))
        assert _wait_free(e) == 0
        # the 4 above, and p3's 2 history blocks (its own chain past the
        # shared 8 tokens); the repeat's history duplicated r1's and stayed
        # private
        assert e._models["toy"].cache.allocator.num_evictable == 6
    finally:
        e.stop()


def test_prefix_cache_off_is_identical():
    prompts = ([2, 3, 4, 5, 6, 7], [2, 3, 4, 5, 8, 9], [2, 3, 4, 5, 6, 7])
    outs = []
    for on in (True, False):
        e = _mkengine(prefix_cache=on)
        try:
            assert (e._models["toy"].prefix is not None) is on
            outs.append([e.generate("toy", list(p), max_new_tokens=6)
                         .outputs["tokens"] for p in prompts])
        finally:
            e.stop()
    for a, b, p in zip(*outs, prompts):
        assert np.array_equal(a, b) and np.array_equal(a, _ref_of(p, 6))


def test_evictable_pool_counts_as_reclaimable_no_shed():
    e = _mkengine(kv_blocks=8, buckets="1")             # 7 usable blocks
    try:
        alloc = e._models["toy"].cache.allocator
        pa_ = list(range(1, 25))           # 6 full prompt blocks park
        r = e.generate("toy", pa_, max_new_tokens=2)
        assert r.status == "ok"
        assert _wait_free(e) == 0
        assert alloc.num_evictable == 6 and alloc.num_free == 1
        pb = [29, 28, 27, 26] * 3          # needs 3 > free, <= reclaimable
        rb = e.generate("toy", pb, max_new_tokens=4)
        assert rb.status == "ok", (rb.status, rb.error)
        assert np.array_equal(rb.outputs["tokens"], _ref_of(pb, 4))
    finally:
        e.stop()


def test_prefill_token_budget_matches_reference():
    e = _mkengine(prefill_token_budget=2)
    try:
        prompts = [[t] * 20 for t in (1, 2, 3, 4)]
        with e._cond:       # all admitted the same iteration
            reqs = [e.submit("toy", p, max_new_tokens=6) for p in prompts]
        replies = [r.wait(timeout=60.0) for r in reqs]
        assert all(r is not None and r.status == "ok" for r in replies)
        for p, r in zip(prompts, replies):
            assert np.array_equal(r.outputs["tokens"], _ref_of(p, 6)), p[0]
        assert _wait_free(e) == 0
    finally:
        e.stop()


# -- lifecycle and construction ----------------------------------------------


def test_drain_sheds_new_arrivals_and_empties():
    e = _mkengine()
    try:
        r = e.submit("toy", [1, 2, 3], max_new_tokens=6)
        assert e.drain(timeout_s=30.0)
        assert r.wait(timeout=10.0).status == "ok"
        late = e.generate("toy", [1], max_new_tokens=2)
        assert late.status == "shed" and late.retry_after_ms >= 1.0
    finally:
        e.stop()


def test_stop_fails_waiting_requests():
    e = _mkengine()
    with e._cond:
        r = e.submit("toy", [1, 2], max_new_tokens=4)
        e._running = False
    e.stop()
    assert r.wait(timeout=10.0).status == "error"


def test_add_model_from_reference_save_dir(tmp_path):
    jcfg = jdm.DecoderConfig(**CFG.to_dict())
    d = jdm.save_decoder(str(tmp_path / "ref"), jcfg, PARAMS)
    e = _mkengine(source=d)
    try:
        r = e.generate("toy", [5, 6, 7], max_new_tokens=6)
        assert np.array_equal(r.outputs["tokens"], _ref_of([5, 6, 7], 6))
    finally:
        e.stop()
    d2 = save_decoder(str(tmp_path / "port"), CFG, PARAMS)
    e = _mkengine(source=d2)
    try:
        kv = e._models["toy"].kv_config
        assert (kv.block_size, kv.num_blocks) == (BS, 64)
        r = e.generate("toy", [5, 6, 7], max_new_tokens=6)
        assert np.array_equal(r.outputs["tokens"], _ref_of([5, 6, 7], 6))
    finally:
        e.stop()


def test_defaults_are_the_reference_flag_defaults():
    e = DecodeEngine(device="cpu")
    assert e.buckets == (4, 8) and e.block_size == 16
    assert e.mode == "token" and e.prefix_cache is True
    assert e.prefill_token_budget == 0
    assert e.max_queue == 256 and e.default_deadline_ms == 2000.0
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError):
        DecodeEngine(mode="batch", device="cpu")


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine()
