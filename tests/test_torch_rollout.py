"""The port's canary rollout (paddle_tpu_torch/serving/rollout.py) and its
wire (the server's ``__rollout_ctl__`` and ``__metrics__``, the client's
``rollout``, ``rollout_state`` and ``scrape``), held against the JAX
package's.

* ``evaluate_gate``, ``stats_from_snapshot`` and ``merge_stats`` equal the
  reference's over the cases of tests/test_serving_control.py:173, :190
  and tests/test_fleetmon.py:398, and over numpy-seeded snapshots.
* The controller's auto rollback (tests/test_serving_control.py:216) and
  its flip and bad ops (:250), on the port's ServingEngine on the CPU.
* Over the wire: the port's client against a port server that runs a
  controller, and the reference's client against a port coordinator;
  the engines' serving metrics scraped from ``__metrics__``.
"""

import bisect
import contextlib
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.serving import ServingClient as JClient
from paddle_tpu.serving import rollout as jro
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.serving import (RolloutController, ServingClient,
                                      ServingEngine, ServingFleet,
                                      ServingServer, evaluate_gate,
                                      merge_stats, stats_from_snapshot)
from paddle_tpu_torch.serving.engine import _route_hash

BOUNDS = ttm.HIST_BUCKET_BOUNDS
X1 = np.ones((1, 8), np.float32)


@pytest.fixture()
def telemetry_on():
    on = {"FLAGS_telemetry": True}
    set_flags(on)
    fluid.set_flags(on)
    ttm.reset()
    jtm.reset()
    yield
    ttm.reset()
    jtm.reset()
    off = {"FLAGS_telemetry": False}
    set_flags(off)
    fluid.set_flags(off)


@pytest.fixture(scope="module")
def fc_dir(tmp_path_factory):
    """The reference test's fc model, saved by the JAX package."""
    d = str(tmp_path_factory.mktemp("fc") / "model")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        h = fluid.layers.fc(x, 16, act="relu")
        out = fluid.layers.fc(h, 4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.save_inference_model(d, ["x"], [out], exe, main_program=main)
    return d


def _engine(fc_dir, **kw):
    kw.setdefault("buckets", (1, 4))
    eng = ServingEngine(device="cpu", **kw)
    eng.add_model("fc", fc_dir)
    eng.add_model("fc@v2", fc_dir)
    return eng


def _hist_dump(samples):
    bk = [0] * (len(BOUNDS) + 1)
    for v in samples:
        bk[bisect.bisect_left(BOUNDS, v)] += 1
    cum, run = [], 0
    for c in bk:
        run += c
        cum.append(run)
    s = sorted(samples)
    return {"count": len(samples),
            "p99": s[min(int(0.99 * len(s)), len(s) - 1)] if s else 0.0,
            "buckets": cum}


# -- the gate, pure (tests/test_serving_control.py:173, :190) ----------------

BASE = {"count": 100, "requests": 100, "errors": 0, "p99_ms": 9.0}
GATE_CASES = {
    "pass": ({"count": 100, "requests": 100, "errors": 1, "p99_ms": 10.0},
             "pass"),
    "errors": ({"count": 100, "requests": 100, "errors": 50,
                "p99_ms": 10.0}, "trip"),
    "slow": ({"count": 100, "requests": 100, "errors": 1, "p99_ms": 30.0},
             "trip"),
    "blip": ({"count": 2, "requests": 2, "errors": 2, "p99_ms": 99.0},
             "insufficient"),
    "no_baseline_p99": ({"count": 50, "requests": 60, "errors": 0,
                         "p99_ms": 500.0}, "pass"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_evaluate_gate_verdicts_equal_the_reference(case):
    canary, want = GATE_CASES[case]
    base = dict(BASE, p99_ms=0.0) if case == "no_baseline_p99" else BASE
    kw = dict(p99_ratio=2.0, error_rate=0.05, min_samples=20)
    got = evaluate_gate(canary, base, **kw)
    assert got == jro.evaluate_gate(canary, base, **kw)
    assert got["verdict"] == want


def test_evaluate_gate_defaults_read_the_reference_flags():
    canary = {"count": 25, "requests": 25, "errors": 1, "p99_ms": 10.0}
    assert evaluate_gate(canary, BASE) == jro.evaluate_gate(canary, BASE)
    set_flags({"FLAGS_rollout_gate_min_samples": 30})
    try:
        assert evaluate_gate(canary, BASE)["verdict"] == "insufficient"
    finally:
        set_flags({"FLAGS_rollout_gate_min_samples": 20})


def test_stats_from_snapshot_and_merge():
    snap = {"histograms": {"serving_execute_ms{model=fc@v2}":
                           {"count": 30, "p99": 12.5}},
            "counters": {"serving_requests_total{model=fc@v2,tenant=t}": 40,
                         "serving_request_errors_total{model=fc@v2}": 10,
                         "serving_requests_total{model=fc,tenant=t}": 7}}
    s = stats_from_snapshot(snap, "fc@v2")
    assert s == jro.stats_from_snapshot(snap, "fc@v2")
    assert s == {"count": 40.0, "requests": 40.0, "errors": 10.0,
                 "p99_ms": 12.5}
    other = {"count": 5, "requests": 5, "errors": 0, "p99_ms": 50.0}
    m = merge_stats([s, other])
    assert m == jro.merge_stats([s, other])
    assert m["count"] == 45.0 and m["p99_ms"] == 50.0


def _snap_for(version, samples, n_req, errors=0):
    counters = {"serving_requests_total{model=%s,tenant=t}" % version:
                float(n_req)}
    if errors:
        counters["serving_request_errors_total{model=%s}" % version] = \
            float(errors)
    return {"histograms": {"serving_execute_ms{model=%s}" % version:
                           _hist_dump(samples)},
            "counters": counters}


def test_rollout_gate_uses_merged_buckets():
    """tests/test_fleetmon.py:398: one replica's blip vanishes in the
    union; a slow union still trips."""
    def both(per):
        got = merge_stats(per)
        assert got == jro.merge_stats(per)
        return got

    base = both([stats_from_snapshot(_snap_for("fc", [10.0] * 300, 300),
                                     "fc"),
                 stats_from_snapshot(_snap_for("fc", [12.0] * 300, 300),
                                     "fc")])
    c1 = stats_from_snapshot(
        _snap_for("fc@v2", [11.0] * 98 + [400.0] * 2, 100), "fc@v2")
    c2 = stats_from_snapshot(_snap_for("fc@v2", [11.0] * 500, 500), "fc@v2")
    assert c1["p99_ms"] == 400.0
    canary = both([c1, c2])
    assert canary["p99_ms"] < 30.0
    kw = dict(p99_ratio=2.0, error_rate=0.1, min_samples=50)
    assert evaluate_gate(canary, base, **kw)["verdict"] == "pass"
    slow = both([stats_from_snapshot(_snap_for("fc@v2", [60.0] * 100, 100),
                                     "fc@v2")] * 2)
    assert evaluate_gate(slow, base, **kw)["verdict"] == "trip"
    # a replica without buckets sends the merge back to the worst one
    old = dict(c1)
    del old["buckets"]
    assert both([old, c2])["p99_ms"] == 400.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_gates_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    per = {}
    for version in ("fc", "fc@v2"):
        per[version] = []
        for _ in range(3):
            n = int(rng.randint(1, 200))
            samples = list(np.exp(rng.uniform(0, 6, n)).astype(float))
            snap = _snap_for(version, samples, n,
                             errors=int(rng.randint(0, 5)))
            s = stats_from_snapshot(snap, version)
            assert s == jro.stats_from_snapshot(snap, version)
            per[version].append(s)
    canary, base = merge_stats(per["fc@v2"]), merge_stats(per["fc"])
    assert canary == jro.merge_stats(per["fc@v2"])
    kw = dict(p99_ratio=float(rng.uniform(1, 3)),
              error_rate=float(rng.uniform(0, 0.05)), min_samples=50)
    assert evaluate_gate(canary, base, **kw) == \
        jro.evaluate_gate(canary, base, **kw)


# -- the controller (tests/test_serving_control.py:216, :250) ----------------

class _FakeServer:
    """Just enough ServingServer surface for RolloutController."""

    def __init__(self, engine):
        self.engine = engine
        self.applied = []

    def apply_rollout(self, doc):
        self.applied.append(doc)


def test_rollout_controller_auto_rollback(fc_dir, telemetry_on):
    eng = _engine(fc_dir)
    bad_snap = {
        "histograms": {"serving_execute_ms{model=fc}":
                       {"count": 100, "p99": 5.0}},
        "counters": {"serving_requests_total{model=fc,tenant=t}": 100,
                     "serving_requests_total{model=fc@v2,tenant=t}": 30,
                     "serving_request_errors_total{model=fc@v2}": 30},
    }
    srv = _FakeServer(eng)
    ctl = RolloutController(srv, fleet=None, snapshot_fn=lambda: bad_snap)
    got = ctl.handle({"op": "start", "model": "fc", "active": "fc",
                      "canary": "fc@v2", "fraction": 0.5})
    assert got["status"] == "ok"
    assert eng.routes()["fc"]["state"] == "canary"
    assert ttm.snapshot()["gauges"]["rollout_state{model=fc}"] == 1
    set_flags({"FLAGS_rollout_gate_min_samples": 10})
    try:
        verdicts = ctl.check_gates()
    finally:
        set_flags({"FLAGS_rollout_gate_min_samples": 20})
    assert verdicts["fc"]["verdict"] == "trip"
    route = eng.routes()["fc"]
    assert route["state"] == "rolled_back"
    assert route["active"] == "fc" and route["canary"] is None
    assert ttm.counter_total("rollout_rollbacks_total") == 1
    assert ttm.snapshot()["gauges"]["rollout_state{model=fc}"] == 3
    assert len(srv.applied) >= 2
    assert ctl.handle({"op": "status"})["gates"]["fc"]["verdict"] == "trip"


def test_rollout_controller_flip_and_bad_ops(fc_dir):
    eng = _engine(fc_dir)
    ctl = RolloutController(_FakeServer(eng), fleet=None)
    assert ctl.handle({"op": "flip", "model": "fc"})["status"] == "error"
    assert ctl.handle({"op": "abort", "model": "zz"})["status"] == "error"
    assert ctl.handle({"op": "start", "model": "fc", "active": "fc",
                       "canary": "nope"})["status"] == "error"
    ctl.handle({"op": "start", "model": "fc", "active": "fc",
                "canary": "fc@v2", "fraction": 0.25})
    assert ctl.handle({"op": "flip", "model": "fc"})["status"] == "ok"
    r = eng.routes()["fc"]
    assert r == {"active": "fc@v2", "canary": None, "fraction": 0.0,
                 "state": "flipped"}
    st = ctl.handle({"op": "status"})
    assert st["status"] == "ok" and "fc" in st["routes"]
    assert ctl.handle({"op": "nope"})["status"] == "error"
    assert ctl.handle({"op": "abort", "model": "fc"})["routes"]["fc"][
        "state"] == "rolled_back"


def test_canary_split_is_the_reference_hash(fc_dir):
    """A request id lands on the canary exactly when the reference's route
    hash puts it below the fraction; a replayed id lands the same."""
    from paddle_tpu.serving.engine import _route_hash as j_hash

    eng = _engine(fc_dir)
    eng.set_route("fc", active="fc", canary="fc@v2", fraction=0.25,
                  state="canary")
    ids = ["req-%04d" % i for i in range(400)]
    for rid in ids:
        assert _route_hash(rid) == j_hash(rid)
        want = "fc@v2" if j_hash(rid) < 0.25 else "fc"
        assert eng.resolve("fc", rid) == want
    assert eng.resolve("fc@v2", "x") == "fc@v2"
    eng.apply_routes({"fc": {"active": "fc", "canary": "fc@v9",
                             "fraction": 0.5, "state": "canary"},
                      "ghost": {"active": "ghost@v1"}})
    assert eng.routes()["fc"]["canary"] == "fc@v2"   # nothing adopted
    assert "ghost" not in eng.routes()


# -- over the wire -----------------------------------------------------------

@contextlib.contextmanager
def _controlled_server(fc_dir, fleet=False):
    eng = _engine(fc_dir)
    eng.prewarm()
    srv = ServingServer(eng, port=0).start()
    try:
        fl = None
        if fleet:
            fl = ServingFleet(0, ["127.0.0.1:%d" % srv.port], srv).start()
        srv.rollout = RolloutController(srv, fl).start()
        yield srv, eng
    finally:
        srv.shutdown()


def _wait_until(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_port_client_rollout_state_and_scrape(fc_dir, telemetry_on):
    with _controlled_server(fc_dir) as (srv, eng):
        ep = "127.0.0.1:%d" % srv.port
        cli = ServingClient(endpoints=[ep])
        got = cli.rollout({"op": "start", "model": "fc", "active": "fc",
                           "canary": "fc@v2", "fraction": 0.5})
        assert got["status"] == "ok"
        route = got["phases"]["routes"]["fc"]
        assert route == {"active": "fc", "canary": "fc@v2", "fraction": 0.5,
                         "state": "canary"}
        assert cli.rollout_state(ep) == {"models": {"fc": route}}
        replies = [cli.infer("fc", {"x": X1}) for _ in range(12)]
        assert all(r.ok for r in replies)
        models = [r.phases["model"] for r in replies]
        assert set(models) <= {"fc", "fc@v2"}
        st = cli.rollout({"op": "status"})
        assert st["status"] == "ok" and "routes" in st["phases"]
        bad = cli.rollout({"op": "flip", "model": "nope"})
        assert bad["status"] == "error" and "nope" in bad["error"]

        def counted():
            c = cli.scrape(ep)["counters"]
            return sum(v for k, v in c.items()
                       if k.startswith("serving_requests_total{")) == 12
        assert _wait_until(counted)
        snap = cli.scrape(ep)
        c = snap["counters"]
        for version in ("fc", "fc@v2"):
            n = models.count(version)
            assert c.get("serving_requests_total{model=%s,tenant=default}"
                         % version, 0) == n
            if n:
                h = snap["histograms"]["serving_execute_ms{model=%s}"
                                       % version]
                assert h["count"] == n
        assert snap["gauges"]["rollout_state{model=fc}"] == 1.0
        assert cli.rollout({"op": "flip", "model": "fc"})["status"] == "ok"
        assert cli.rollout_state(ep)["models"]["fc"]["state"] == "flipped"
        assert all(cli.infer("fc", {"x": X1}).phases["model"] == "fc@v2"
                   for _ in range(4))


def test_reference_client_against_a_port_coordinator(fc_dir, telemetry_on):
    """The JAX package's client drives a port coordinator's rollout and
    reads its state and metrics."""
    with _controlled_server(fc_dir, fleet=True) as (srv, eng):
        ep = "127.0.0.1:%d" % srv.port
        theirs = JClient(endpoints=[ep])
        assert theirs.alive(ep)[2] == 1             # the coordinator
        got = theirs.rollout({"op": "start", "model": "fc", "active": "fc",
                              "canary": "fc@v2", "fraction": 0.25})
        assert got["status"] == "ok"
        assert theirs.rollout_state(ep)["models"]["fc"]["state"] == "canary"
        assert theirs.infer("fc", {"x": X1}).ok
        assert theirs.rollout({"op": "flip", "model": "fc"})["status"] == \
            "ok"
        assert eng.routes()["fc"]["active"] == "fc@v2"
        assert _wait_until(lambda: "serving_requests_total" in " ".join(
            theirs.scrape(ep)["counters"]))
        # the fleet published the route beside the endpoints, epoch bumped
        assert srv.fleet.rollout_doc["models"]["fc"]["state"] == "flipped"
        assert srv.fleet.epoch >= 2


def test_a_follower_refuses_rollout_commands(fc_dir):
    """A non-coordinator's controller answers "not coordinator"; the
    client then tries the next endpoint and, with none left, raises."""
    eng = _engine(fc_dir)
    srv = ServingServer(eng, port=0).start()
    try:
        ep = "127.0.0.1:%d" % srv.port
        fl = ServingFleet(1, ["127.0.0.1:1", ep], srv)
        srv.fleet = fl                       # attached, never started
        srv.rollout = RolloutController(srv, fl)
        assert srv.rollout.handle({"op": "status"})["error"] == \
            "not coordinator"
        with pytest.raises(ConnectionError, match="coordinator"):
            ServingClient(endpoints=[ep]).rollout({"op": "status"},
                                                  timeout=5.0)
    finally:
        srv.shutdown()
