"""The port's telemetry (paddle_tpu_torch/core/telemetry.py), its heartbeat
monitor (distributed/ps.py) and its RPC counters, held against the JAX
package's on the same inputs.

* The reference's registry, off-path, scrape and heartbeat tests
  (tests/test_telemetry.py:39, :66, :202, :220, :234) re-posed on the
  port, with the two packages' snapshots compared where both run.
* The pure parts of tests/test_fleetmon.py (:72-178): the histogram
  bounds, bucket vectors, merges, percentiles, rates and the series ring
  equal the reference's on numpy-seeded samples, and so does
  ``prometheus_text``.
* A port ``__metrics__`` snapshot is read by the reference's ``scrape``,
  and the other way round.

Telemetry state is per process: the fixture below resets both packages'
registries and flags after every test.
"""

import bisect
import json
import os
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.distributed.ps import HeartBeatMonitor as JMonitor
from paddle_tpu.native import rpc as jrpc
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.distributed.ps import HeartBeatMonitor
from paddle_tpu_torch.native import rpc as trpc

BOUNDS = ttm.HIST_BUCKET_BOUNDS
OFF = {"FLAGS_telemetry": False, "FLAGS_telemetry_dir": "",
       "FLAGS_telemetry_series_cap": 1024}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    yield
    set_flags(OFF)
    fluid.set_flags(OFF)
    ttm.reset()
    jtm.reset()


def _on(**extra):
    """Telemetry on in both packages, both registries empty."""
    flags = dict({"FLAGS_telemetry": True}, **extra)
    set_flags(flags)
    fluid.set_flags(flags)
    ttm.reset()
    jtm.reset()


def _both(fn):
    """Run ``fn(telemetry module)`` on each package -> (port's, ref's)."""
    return fn(ttm), fn(jtm)


def _samples(seed, n=500):
    """Latencies over five decades, with exact bucket bounds mixed in."""
    rng = np.random.RandomState(seed)
    v = np.exp(rng.uniform(np.log(0.01), np.log(2e5), n))
    edges = rng.choice(len(BOUNDS), 20)
    return [float(x) for x in v] + [float(BOUNDS[i]) for i in edges]


# -- registry (tests/test_telemetry.py:39) -----------------------------------

def _registry_ops(tm):
    tm.inc("reqs_total")
    tm.inc("reqs_total", 2, ep="a")
    tm.inc("reqs_total", 3, ep="b")
    tm.set_gauge("depth", 7, q="in")
    for v in (1.0, 2.0, 3.0, 4.0):
        tm.observe("lat_ms", v)
    tm.observe("lat_ms", 12.5, model="bert", tier="paid")
    tm.set_info("k", {"v": 1})
    return tm.snapshot()


def test_registry_counters_gauges_histograms():
    _on()
    snap, ref = _both(_registry_ops)
    assert snap == ref
    assert snap["counters"]["reqs_total"] == 1
    assert snap["counters"]["reqs_total{ep=a}"] == 2
    assert snap["counters"]["reqs_total{ep=b}"] == 3
    assert ttm.counter_total("reqs_total") == 6.0
    assert snap["gauges"]["depth{q=in}"] == 7.0
    h = snap["histograms"]["lat_ms"]
    assert h["count"] == 4 and h["sum"] == 10.0
    assert h["min"] == 1.0 and h["max"] == 4.0
    assert h["p50"] in (2.0, 3.0)
    assert "lat_ms{model=bert,tier=paid}" in snap["histograms"]
    assert ttm.label_sets("reqs_total") == jtm.label_sets("reqs_total")
    prom = ttm.prometheus_text(snap)
    assert prom == jtm.prometheus_text(ref)
    assert "# TYPE reqs_total counter" in prom
    assert 'reqs_total{ep="a"} 2' in prom
    assert "# TYPE lat_ms summary" in prom
    assert 'lat_ms{quantile="0.5"}' in prom
    assert "lat_ms_count 4" in prom


def test_disabled_is_inert_and_touches_no_files(tmp_path):
    """tests/test_telemetry.py:66: with the flag off nothing is recorded
    and the telemetry dir is never created; the port's executor runs
    three steps and the registry stays empty."""
    from paddle_tpu_torch import framework, layers
    from paddle_tpu_torch.core import Executor, Scope, scope_guard

    d = str(tmp_path / "telem")
    set_flags({"FLAGS_telemetry": False, "FLAGS_telemetry_dir": d})
    ttm.reset()
    ttm.inc("c_total")
    ttm.set_gauge("g", 1)
    ttm.observe("h_ms", 3.0)
    ttm.event("step", n=1)
    ttm.record_step(1.0, True)
    ttm.set_info("k", {"v": 1})
    ttm.maybe_dump()
    assert ttm.series_record() is None
    snap = ttm.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {} and snap["events_logged"] == {}
    assert "info" not in snap
    assert not os.path.exists(d)

    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        loss = layers.mean(layers.fc(x, 3))
    exe = Executor(framework.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((2, 4), "f")},
                    fetch_list=[loss])
    assert ttm.snapshot()["counters"] == {}
    assert not os.path.exists(d)


def test_events_record_step_and_dump_match_the_reference(tmp_path):
    """The JSONL stream and the dump files: the same events and steps
    give the same records (the time stamp aside), metrics.json and
    metrics.prom."""
    dirs = {}
    for name, tm in (("port", ttm), ("ref", jtm)):
        dirs[name] = str(tmp_path / name)
        _on(FLAGS_telemetry_dir=dirs[name])
        tm.event("serving_prewarm", model="bert", bucket=8, ms=1.5)
        tm.record_step(3.25, False, compile_ms=7.0, feed_bytes=64)
        tm.record_step(2.5, True, donated=2, carry_hits=3)
        tm.dump()
        tm.reset()                    # closes the stream
    recs = {}
    for name, d in dirs.items():
        with open(os.path.join(d, "steps.jsonl")) as f:
            recs[name] = [json.loads(line) for line in f]
        for r in recs[name]:
            assert r.pop("t") > 0
    assert recs["port"] == recs["ref"]
    assert [r["ev"] for r in recs["port"]] == ["serving_prewarm", "step",
                                               "step"]
    for fname in ("metrics.json", "metrics.prom"):
        with open(os.path.join(dirs["port"], fname)) as a, \
                open(os.path.join(dirs["ref"], fname)) as b:
            assert a.read() == b.read(), fname


def test_event_stream_rotates_past_max_bytes(tmp_path):
    d = str(tmp_path / "rot")
    _on(FLAGS_telemetry_dir=d, FLAGS_telemetry_max_bytes=400)
    try:
        for i in range(40):
            ttm.event("tick", i=i)
        ttm.reset()
        assert os.path.getsize(os.path.join(d, "steps.jsonl")) <= 400
        assert os.path.exists(os.path.join(d, "steps.jsonl.1"))
    finally:
        set_flags({"FLAGS_telemetry_max_bytes": 256 << 20})
        fluid.set_flags({"FLAGS_telemetry_max_bytes": 256 << 20})


# -- the __metrics__ RPC (tests/test_telemetry.py:202, :220) -----------------

def _publish_and_scrape(server_mod, tm_pub, tm_scrape):
    server = server_mod.RpcServer(port=0)
    try:
        server.serve(True)
        tm_pub.publish_rpc(server)
        return tm_scrape.scrape("127.0.0.1:%d" % server.port, timeout=15.0)
    finally:
        server.shutdown()


@pytest.mark.parametrize("server,publisher,scraper", [
    ("port", "port", "port"), ("port", "port", "ref"),
    ("ref", "ref", "port")])
def test_metrics_rpc_publish_and_scrape(server, publisher, scraper):
    """A snapshot published under __metrics__ on either package's server
    is read back whole by either package's scrape."""
    mods = {"port": (trpc, ttm), "ref": (jrpc, jtm)}
    _on()
    tm = mods[publisher][1]
    tm.inc("demo_total", 5, role="server")
    tm.observe("server_ms", 3.5, tier="paid")
    want = json.loads(json.dumps(tm.snapshot()))   # before the GET counts
    snap = _publish_and_scrape(mods[server][0], tm, mods[scraper][1])
    assert snap["counters"]["demo_total{role=server}"] == 5
    assert snap == want
    assert snap["bucket_bounds"] == list(BOUNDS)


def test_start_publisher_republishes_and_stops():
    _on()
    server = trpc.RpcServer(port=0)
    try:
        server.serve(True)
        ttm.inc("before_total")
        handle = ttm.start_publisher(server, interval_s=0.05)
        ep = "127.0.0.1:%d" % server.port
        assert "before_total" in ttm.scrape(ep)["counters"]
        ttm.inc("after_total", 2)
        deadline = time.time() + 10.0
        while time.time() < deadline and \
                "after_total" not in ttm.scrape(ep)["counters"]:
            time.sleep(0.02)
        assert ttm.scrape(ep)["counters"]["after_total"] == 2
        assert len(ttm.series()) >= 2       # a ring sample a tick
        handle.stop()
        assert handle.thread is None and handle.is_set()
        handle.stop()                       # idempotent
    finally:
        server.shutdown()


def test_publish_rpc_disabled_publishes_nothing():
    class _FakeServer:
        def __init__(self):
            self.calls = []

        def set_var(self, name, arr):
            self.calls.append(name)

    set_flags({"FLAGS_telemetry": False})
    s = _FakeServer()
    ttm.publish_rpc(s)
    assert s.calls == []


def test_rpc_counters_match_the_reference():
    """The seven RPC counters: a send, a get, and a get that fails and
    retries, counted by each package's client against the port's
    server under the same names and labels."""
    _on()
    server = trpc.RpcServer(port=0)
    try:
        server.set_var("held", np.arange(6, dtype=np.float32))
        server.serve(True)
        ep = "127.0.0.1:%d" % server.port

        def drive(rpc):
            c = rpc.RpcClient(ep, connect_timeout=5.0, rpc_deadline=5.0,
                              retry_times=1)
            try:
                c.send_var("up", np.ones(4, np.float32))
                c.get_var("held")
                c.rpc_deadline = 0.2
                c._lib.rpcc_set_deadline(c._h, 0.2)
                with pytest.raises(ConnectionError):
                    c.get_var("never")
            finally:
                c.close()

        drive(trpc)
        drive(jrpc)
    finally:
        server.shutdown()
    port, ref = ttm.snapshot()["counters"], jtm.snapshot()["counters"]
    assert port == ref
    assert port["rpc_send_total"] == 1
    assert port["rpc_send_bytes_total"] == 16
    assert port["rpc_get_total"] == 2
    assert port["rpc_retry_total{op=get_var}"] == 1
    assert port["rpc_failure_total{op=get_var}"] == 2
    assert port["rpc_exhausted_total{op=get_var}"] == 1


# -- heartbeats (tests/test_telemetry.py:234) --------------------------------

@pytest.mark.parametrize("cls", [HeartBeatMonitor, JMonitor],
                         ids=["port", "ref"])
def test_heartbeat_monitor_gauge_and_miss_counter(cls):
    _on()
    m = cls(2, timeout_s=0.05, name="t0", startup_grace_s=0.0)
    m.update(0)
    m.update(1)
    time.sleep(0.12)
    m.update(1)  # worker 1 stays alive; worker 0 goes silent
    assert m.check() == [0]
    tm = ttm if cls is HeartBeatMonitor else jtm
    snap = tm.snapshot()
    assert snap["gauges"]["ps_dead_workers{ps=t0}"] == 1.0
    assert tm.counter_total("ps_heartbeat_miss_total") == 1
    assert m.check() == [0]
    assert tm.counter_total("ps_heartbeat_miss_total") == 1
    m.remove(0)
    assert m.check() == []
    assert tm.snapshot()["gauges"]["ps_dead_workers{ps=t0}"] == 0.0


def test_heartbeat_monitor_defaults_read_the_flag():
    set_flags({"FLAGS_worker_hb_timeout": 7.5})
    try:
        m = HeartBeatMonitor(0, worker_ids=[3, 5])
        assert m.timeout_s == 7.5 and m.startup_grace_s == 7.5
        assert m.n_workers == 2 and m.check() == []
    finally:
        set_flags({"FLAGS_worker_hb_timeout": 60.0})


# -- mergeable histograms (tests/test_fleetmon.py:72-178) --------------------

def test_bucket_bounds_equal_the_reference_bitwise():
    assert ttm.HIST_BUCKET_BOUNDS == jtm.HIST_BUCKET_BOUNDS
    assert ttm._log_bounds(0.05, 120000.0, 1.25) == BOUNDS
    assert len(BOUNDS) == len(jtm.HIST_BUCKET_BOUNDS)


def _hist_dump(samples):
    """A snapshot-shaped histogram dict from raw samples."""
    bk = [0] * (len(BOUNDS) + 1)
    for v in samples:
        bk[bisect.bisect_left(BOUNDS, v)] += 1
    cum, run = [], 0
    for c in bk:
        run += c
        cum.append(run)
    s = sorted(samples)

    def p(q):
        return s[min(int(q * len(s)), len(s) - 1)] if s else 0.0

    return {"count": len(samples), "sum": sum(samples),
            "min": min(samples) if samples else 0.0,
            "max": max(samples) if samples else 0.0,
            "p50": p(0.5), "p90": p(0.9), "p99": p(0.99), "buckets": cum}


def _union_p(samples, q):
    s = sorted(samples)
    return s[min(int(q * len(s)), len(s) - 1)]


def _bucket_ub(v):
    return BOUNDS[min(bisect.bisect_left(BOUNDS, v), len(BOUNDS) - 1)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observed_buckets_and_snapshot_equal_the_reference(seed):
    """The same observations give the same bucket vectors, percentiles
    and snapshot in both packages, bit for bit."""
    _on()
    vals = _samples(seed)

    def run(tm):
        for v in vals:
            tm.observe("server_ms", v, tier="paid")
        return tm.snapshot()

    snap, ref = _both(run)
    assert snap == ref
    h = snap["histograms"]["server_ms{tier=paid}"]
    assert h["buckets"][-1] == len(vals)
    assert ttm.cumulative_to_deltas(h["buckets"]) == \
        jtm.cumulative_to_deltas(h["buckets"])
    for q in (0.5, 0.9, 0.99, 1.0):
        assert ttm.bucket_percentile(h["buckets"], q) == \
            jtm.bucket_percentile(h["buckets"], q)


def test_hist_buckets_merge_exact_three_replicas():
    reps = [[5.0 + 0.01 * i for i in range(400)],
            [40.0] * 350 + [900.0] * 50,
            [0.2] * 450]
    dumps = [_hist_dump(r) for r in reps]
    merged = ttm.merge_hist_snapshots(dumps)
    assert merged == jtm.merge_hist_snapshots(dumps)
    union = [v for r in reps for v in r]
    assert merged["count"] == len(union)
    assert merged["sum"] == pytest.approx(sum(union))
    assert merged["min"] == pytest.approx(min(union))
    assert merged["max"] == pytest.approx(max(union))
    for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        assert merged[key] == _bucket_ub(_union_p(union, q))


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_of_seeded_replicas_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    dumps = [_hist_dump(_samples(int(s), int(n)))
             for s, n in zip(rng.randint(0, 1000, 4),
                             rng.randint(1, 300, 4))]
    dumps.append(None)                    # a replica that sent nothing
    merged = ttm.merge_hist_snapshots(dumps)
    assert merged == jtm.merge_hist_snapshots(dumps)
    assert merged["count"] == sum(d["count"] for d in dumps if d)


def test_hist_merge_bucketless_falls_back_to_worst():
    a = _hist_dump([10.0] * 99 + [500.0])
    b = {"count": 100, "p99": 11.0}
    merged = ttm.merge_hist_snapshots([a, b])
    assert merged == jtm.merge_hist_snapshots([a, b])
    assert merged["p99"] == max(a["p99"], 11.0)
    assert "buckets" not in merged


def test_hist_object_merge_and_sorted_cache():
    h1, h2 = ttm._Hist(), ttm._Hist()
    for v in (1.0, 2.0, 3.0):
        h1.add(v)
    assert h1.percentile(0.5) == 2.0
    assert h1._sorted is not None
    h1.add(0.5)
    assert h1._sorted is None
    assert h1.percentile(0.5) == 2.0
    for v in (100.0, 200.0):
        h2.add(v)
    h1.merge(h2)
    assert h1.count == 6 and h1.max == 200.0
    assert h1.buckets[-1] == 0 and sum(h1.buckets) == 6
    j1 = jtm._Hist()
    for v in (1.0, 2.0, 3.0, 0.5, 100.0, 200.0):
        j1.add(v)
    assert h1.cumulative() == j1.cumulative()


def test_hist_sample_cap_decimates_but_buckets_stay_exact():
    h, j = ttm._Hist(), jtm._Hist()
    vals = _samples(9, 9000)
    for v in vals:
        h.add(v)
        j.add(v)
    assert len(h.samples) <= ttm._HIST_SAMPLE_CAP
    assert h.samples == j.samples and h.buckets == j.buckets
    assert sum(h.buckets) == len(vals)


def test_empty_hist_dump_is_finite_json():
    _on()
    ttm._hists[ttm._key("lat_ms", {})] = ttm._Hist()
    snap = ttm.snapshot()
    h = snap["histograms"]["lat_ms"]
    assert h["min"] == 0.0 and h["max"] == 0.0
    json.dumps(snap, allow_nan=False)


def test_bucket_percentile_rank_convention():
    h = _hist_dump([7.0] * 100)
    assert ttm.bucket_percentile(h["buckets"], 0.99) == _bucket_ub(7.0)
    assert ttm.bucket_percentile([0] * 5, 0.99) == 0.0
    assert ttm.bucket_percentile([], 0.5) == 0.0


# -- time-series ring and windowed rates -------------------------------------

RATE_CASES = {
    "windowed": ([(0.0, 0.0), (10.0, 50.0), (20.0, 100.0), (30.0, 160.0)],
                 [(None, None, 160.0 / 30.0), (10.0, 30.0, 6.0)]),
    "counter_reset": ([(0.0, 0.0), (10.0, 100.0), (20.0, 5.0), (30.0, 15.0)],
                      [(None, None, (100.0 + 5.0 + 10.0) / 30.0)]),
    "one_in_window": ([(0.0, 0.0), (10.0, 40.0), (20.0, 90.0)],
                      [(5.0, 20.0, 5.0), (1.0, 50.0, 0.0)]),
    "single": ([(3.0, 7.0)], [(None, None, 0.0)]),
}


@pytest.mark.parametrize("case", sorted(RATE_CASES))
def test_rate_from_samples(case):
    pts, checks = RATE_CASES[case]
    for window, now, want in checks:
        got = ttm.rate_from_samples(pts, window_s=window, now=now)
        assert got == jtm.rate_from_samples(pts, window_s=window, now=now)
        assert got == pytest.approx(want)


def test_series_ring_and_series_rate():
    _on()

    def run(tm):
        for t in range(5):
            tm.inc("reqs_total", 10)
            tm.set_gauge("depth", t)
            tm.series_record(now=float(t))
        return (tm.series(), tm.series(window_s=2.5, now=4.0),
                tm.series_rate("reqs_total", window_s=3.0, now=4.0))

    port, ref = _both(run)
    assert port == ref
    assert len(port[0]) == 5 and port[1][0]["t"] == 2.0
    assert port[2] == pytest.approx(10.0)


def test_series_ring_bounded():
    _on(FLAGS_telemetry_series_cap=8)
    for t in range(50):
        ttm.series_record(now=float(t))
    assert len(ttm.series()) == 8
    assert ttm.series()[0]["t"] == 42.0


@pytest.mark.parametrize("seed", [5, 6])
def test_prometheus_text_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    _on()

    def run(tm):
        for i in range(30):
            tm.inc("serving_requests_total", int(rng_vals[i] % 5) + 1,
                   model="m%d" % (i % 3), tenant="t")
            tm.set_gauge("kv_pool_occupancy", float(rng_vals[i] % 97) / 97,
                         model="m%d" % (i % 2))
            tm.observe("itl_ms", float(rng_vals[i]) / 7.0,
                       model="m%d" % (i % 2))
        return tm.prometheus_text()

    rng_vals = rng.randint(0, 10000, 30)
    port, ref = _both(run)
    assert port == ref
    assert "# TYPE itl_ms summary" in port


# -- the engines' metrics ----------------------------------------------------

SERVING_FAMILIES = {
    "serving_requests_total", "serving_execute_ms", "serving_latency_ms",
    "serving_queue_depth", "serving_deadline_met_total",
    "serving_tokens_generated_total", "serving_batch_fill",
    "serving_batches_total", "serving_prewarm_total",
    "serving_decode_steps_total", "serving_decode_requests_total",
    "serving_qps", "ttft_ms", "itl_ms", "server_ms",
    "decode_batch_occupancy", "kv_pool_occupancy",
    "kv_pool_reclaimable_ratio", "prefix_cache_hit_rate", "rollout_state",
    "serving_deadline_tokens_total", "serving_shed_total",
    "serving_tier_shed_total", "serving_abort_total",
}


def _families(snap):
    return {k.split("{", 1)[0] for kind in ("counters", "gauges",
                                            "histograms")
            for k in snap[kind]}


def _label_keys(snap):
    return {(kind, k) for kind in ("counters", "gauges", "histograms")
            for k in snap[kind]}


def test_engine_metrics_use_the_reference_names_and_labels(tmp_path):
    """The same traffic through the port's engines and the reference's:
    every metric the port records is one the reference records, with
    the same labels, and the counters of the requests and tokens agree.
    Timing-dependent values aside, the label sets are equal."""
    from paddle_tpu.serving import DecodeEngine as JDecodeEngine
    from paddle_tpu.serving import ServingEngine as JServingEngine
    from paddle_tpu.serving import decode_model as jdm
    from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                          ServingEngine, init_decoder_params)

    d = str(tmp_path / "fc")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        out = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 4)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.save_inference_model(d, ["x"], [out], exe, main_program=main)
    cfg = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
    params = init_decoder_params(cfg, seed=7)
    old = fluid.get_flags(["FLAGS_kv_block_size", "FLAGS_kv_cache_dtype"])
    fluid.set_flags({"FLAGS_kv_block_size": 4,
                     "FLAGS_kv_cache_dtype": "f32"})
    try:
        jdec = JDecodeEngine(buckets="2", deadline_ms=30000.0)
        jdec.add_model("toy", (jdm.DecoderConfig(**cfg.to_dict()), params),
                       kv_blocks=64)
    finally:
        fluid.set_flags(old)
    pdec = DecodeEngine(buckets="2", block_size=4, deadline_ms=30000.0,
                        device="cpu")
    pdec.add_model("toy", (cfg, params), kv_blocks=64)
    pens = ServingEngine(buckets=(1, 4), device="cpu")
    jens = JServingEngine(buckets=(1, 4))
    _on()
    xs = np.random.RandomState(0).rand(5, 1, 8).astype(np.float32)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 2]]
    for ens, dec in ((pens, pdec), (jens, jdec)):
        for name in ("fc", "fc@v2"):
            ens.add_model(name, d)
        ens.prewarm()
        ens.set_route("fc", active="fc", canary="fc@v2", fraction=0.5,
                      state="canary")
        ens.start()
        dec.start()
        try:
            for i, xi in enumerate(xs):
                r = ens.submit("fc", {"x": xi}, req_id="r%d" % i,
                               tier="paid" if i % 2 else None).wait(30.0)
                assert r.ok, r.error
            for p in prompts:      # the second hits the first's prefix
                assert dec.generate("toy", p, max_new_tokens=4).ok
        finally:
            ens.stop()
            dec.stop()
    port, ref = ttm.snapshot(), jtm.snapshot()
    assert _label_keys(port) <= _label_keys(ref), \
        sorted(_label_keys(port) - _label_keys(ref))
    want = SERVING_FAMILIES - {"serving_shed_total",
                               "serving_tier_shed_total",
                               "serving_abort_total"}
    assert want <= _families(port), sorted(want - _families(port))
    for k, v in port["counters"].items():
        if k.startswith(("serving_requests_total", "serving_prewarm_total",
                         "serving_decode_requests_total",
                         "serving_tokens_generated_total",
                         "serving_deadline_")):
            assert v == ref["counters"][k], k
    for k in ("ttft_ms{model=toy}", "itl_ms{model=toy}",
              "server_ms{tier=paid}", "server_ms{tier=default}"):
        assert port["histograms"][k]["count"] == \
            ref["histograms"][k]["count"], k
    assert port["gauges"]["prefix_cache_hit_rate{model=toy}"] == \
        ref["gauges"]["prefix_cache_hit_rate{model=toy}"] > 0
