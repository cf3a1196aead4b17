"""The PyTorch port's ServingEngine (paddle_tpu_torch/serving/engine.py)
on ``device="cpu"`` over a BERT_TINY directory saved by the JAX package,
buckets (1, 4), as the reference's acceptance scenario
(tests/test_serving.py:265-327) runs it.

Replies for mixed row counts coalesce into padded buckets and must equal
the JAX predictor on the same rows (atol 1e-5 at real tokens, 1e-3 at
masked ones: see test_torch_bert_inference.py).  Also the admission
rules: malformed feeds fail fast, a full queue and a blown deadline
budget shed with retry_after_ms, queued requests time out, tiers evict,
and drain() and stop() behave as the reference's."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.serving import (ServingEngine, parse_buckets,
                                      parse_tier_weights, tier_weight)
from test_torch_bert_inference import (SEQ, _jax_predictor, _only,
                                       assert_bert_close, bert_feeds,
                                       save_jax_bert_tiny)

HIDDEN = 64


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    return save_jax_bert_tiny(str(tmp_path_factory.mktemp("bert")))


def _engine(bert_dir, **kw):
    kw.setdefault("buckets", (1, 4))
    kw.setdefault("device", "cpu")
    eng = ServingEngine(**kw)
    eng.add_model("bert", bert_dir)
    return eng


def test_parse_buckets_and_tiers():
    assert parse_buckets("1, 4,16") == (1, 4, 16)
    with pytest.raises(ValueError):
        parse_buckets("0,4")
    w = parse_tier_weights("paid:1.0,free:0.45")
    assert tier_weight(w, "free") == ("free", 0.45)
    assert tier_weight(w, None) == ("default", 1.0)
    assert tier_weight(w, "unknown") == ("unknown", 0.45)
    with pytest.raises(ValueError):
        parse_tier_weights("paid:1.5")


def test_bert_tiny_two_buckets_match_the_jax_predictor(bert_dir):
    """The acceptance scenario: rows 1, 3, 4, 2 reply ok with
    [rows, SEQ, hidden] and the JAX predictor's values on those rows."""
    eng = _engine(bert_dir, batch_window_ms=10.0)
    manifest = eng.prewarm()
    assert set(manifest["bert"]) == {1, 4}
    assert all(e["source"] == "compiled" for e in manifest["bert"].values())
    assert eng.prewarm()["bert"][4]["source"] == "memory"
    direct = _jax_predictor(bert_dir)
    rng = np.random.RandomState(3)
    eng.start()
    try:
        for rows in (1, 3, 4, 2):
            feeds = bert_feeds(rng, rows)
            r = eng.infer("bert", feeds, deadline_ms=60000)
            assert r.ok, r.error
            name, out = _only(r.outputs)
            assert out.shape == (rows, SEQ, HIDDEN)
            assert r.phases["bucket"] == (1 if rows == 1 else 4)
            _, want = _only(direct._run_feed(feeds))
            assert_bert_close(out, want, feeds["input_mask"])
    finally:
        eng.stop()
    assert [b["bucket"] for b in eng.batch_log] == [1, 4, 4, 4]


def test_concurrent_requests_coalesce_and_slice_per_request(bert_dir):
    eng = _engine(bert_dir, batch_window_ms=500.0)
    direct = _jax_predictor(bert_dir)
    rng = np.random.RandomState(5)
    feeds = [bert_feeds(rng, rows) for rows in (1, 2, 1)]
    eng.start()
    try:
        pend = [eng.submit("bert", f, deadline_ms=60000) for f in feeds]
        replies = [p.wait(30.0) for p in pend]
    finally:
        eng.stop()
    for f, r in zip(feeds, replies):
        assert r is not None and r.ok, getattr(r, "error", "no reply")
        _, want = _only(direct._run_feed(f))
        assert_bert_close(_only(r.outputs)[1], want, f["input_mask"])
    # one padded bucket-4 batch served all three requests
    assert [(b["bucket"], b["rows"], b["requests"])
            for b in eng.batch_log] == [(4, 4, 3)]


def test_malformed_feeds_fail_fast(bert_dir):
    eng = _engine(bert_dir)
    eng.start()
    try:
        good = bert_feeds(np.random.RandomState(0), 1)
        missing = dict(good)
        del missing["input_mask"]
        r = eng.infer("bert", missing)
        assert r.status == "error" and "missing feed" in r.error
        bad = dict(good, src_ids=np.zeros((1, SEQ + 1, 1), np.int64))
        assert eng.infer("bert", bad).status == "error"
        big = bert_feeds(np.random.RandomState(0), 5)
        r = eng.infer("bert", big)
        assert r.status == "error" and "exceed" in r.error
        assert eng.infer("nope", good).status == "error"
    finally:
        eng.stop()
    assert not eng.batch_log


def test_queue_full_and_deadline_budget_shed(bert_dir):
    eng = _engine(bert_dir, max_queue=0)
    eng.start()
    try:
        x = bert_feeds(np.random.RandomState(1), 1)
        r = eng.infer("bert", x)
        assert r.status == "shed" and "queue full" in r.error
        assert r.retry_after_ms > 0
        # deadline-budget shed: the projected wait (EWMA batch time)
        # exceeds the deadline before the request would queue
        eng.max_queue = 64
        eng._models["bert"].svc_ms = 1000.0
        r = eng.submit("bert", x, deadline_ms=5.0).wait(5.0)
        assert r.status == "shed" and "projected wait" in r.error
        assert r.retry_after_ms > 0
        # a free-tier request sheds where a paid one of the same deadline
        # is admitted (tier weight scales the budget)
        eng._models["bert"].svc_ms = 500.0
        r = eng.submit("bert", x, deadline_ms=1000.0, tier="free").wait(5.0)
        assert r.status == "shed" and r.phases["tier"] == "free"
        eng._models["bert"].svc_ms = 0.0
        assert eng.infer("bert", x, deadline_ms=60000, tier="paid").ok
    finally:
        eng.stop()


def test_higher_tier_arrival_evicts_from_a_full_queue(bert_dir):
    eng = _engine(bert_dir, max_queue=1)
    x = bert_feeds(np.random.RandomState(2), 1)
    eng._running = True  # admit without a dispatcher: the queue holds
    low = eng.submit("bert", x, tier="batch", deadline_ms=60000)
    high = eng.submit("bert", x, tier="paid", deadline_ms=60000)
    r = low.wait(1.0)
    assert r.status == "shed" and "evicted" in r.error
    eng._running = False
    eng.start()
    try:
        assert high.wait(30.0).ok
    finally:
        eng.stop()


def test_queued_request_times_out(bert_dir):
    eng = _engine(bert_dir, batch_window_ms=0.0)
    eng._running = True
    req = eng.submit("bert", bert_feeds(np.random.RandomState(3), 1),
                     deadline_ms=1.0)
    time.sleep(0.05)
    eng._running = False
    eng.start()
    try:
        r = req.wait(timeout=10.0)
        assert r is not None and r.status == "timeout"
    finally:
        eng.stop()


def test_drain_finishes_admitted_work_then_sheds(bert_dir):
    eng = _engine(bert_dir, batch_window_ms=20.0)
    rng = np.random.RandomState(4)
    eng.start()
    try:
        pend = [eng.submit("bert", bert_feeds(rng, 1), deadline_ms=60000)
                for _ in range(3)]
        assert eng.drain(timeout_s=30.0)
        assert eng.draining
        assert all(p.wait(1.0).ok for p in pend)
        r = eng.infer("bert", bert_feeds(rng, 1))
        assert r.status == "shed" and "draining" in r.error
    finally:
        eng.stop()


def test_stop_fails_queued_requests(bert_dir):
    eng = _engine(bert_dir)
    eng._running = True
    req = eng.submit("bert", bert_feeds(np.random.RandomState(6), 1),
                     deadline_ms=60000)
    eng.stop()
    r = req.wait(1.0)
    assert r.status == "error" and "stopped" in r.error
    r = eng.infer("bert", bert_feeds(np.random.RandomState(6), 1))
    assert r.status == "error" and "not running" in r.error


def test_versioned_routing_splits_by_request_hash(bert_dir):
    eng = _engine(bert_dir)
    eng.add_model("bert@v2", bert_dir)
    eng.set_route("bert", active="bert", canary="bert@v2", fraction=0.5)
    picks = {eng.resolve("bert", "req-%d" % i) for i in range(64)}
    assert picks == {"bert", "bert@v2"}
    assert eng.resolve("bert@v2", "anything") == "bert@v2"
    eng.clear_route("bert")
    assert eng.resolve("bert", "req-1") == "bert"
    with pytest.raises(ValueError):
        eng.set_route("bert", active="missing")
    spec = eng.spec("bert")
    assert spec["buckets"] == [1, 4]
    assert spec["feeds"]["src_ids"]["shape"] == [SEQ, 1]


def test_engine_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServingEngine()


def test_requests_from_threads_all_answered(bert_dir):
    eng = _engine(bert_dir, batch_window_ms=5.0)
    rng = np.random.RandomState(8)
    feeds = [bert_feeds(rng, 1 + i % 4) for i in range(8)]
    out = {}
    eng.start()
    try:
        def client(i):
            out[i] = eng.infer("bert", feeds[i], deadline_ms=60000)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
    finally:
        eng.stop()
    assert len(out) == 8
    for i, r in out.items():
        assert r.ok, r.error
        assert _only(r.outputs)[1].shape == (feeds[i]["src_ids"].shape[0],
                                             SEQ, HIDDEN)
