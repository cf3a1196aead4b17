"""The port's fleet metrics plane (paddle_tpu_torch/serving/fleetmon.py)
and autoscaler (serving/fleet.py ``AutoScaler``), held against the JAX
package's.

Each test re-poses one of tests/test_fleetmon.py:164-372 or
tests/test_serving_control.py:292-336 and drives the port's object and
the reference's side by side with the same fake replicas and clock: every
fleet document, every alert and every scaling decision must be equal,
and so must the telemetry each side records.  Everything is in process
and clock-injected: no sockets, no sleeps.
"""

import bisect
import logging

import pytest

import paddle_tpu as fluid
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import fleetmon as jfm
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.serving import fleet as tfleet
from paddle_tpu_torch.serving import fleetmon as tfm

BOUNDS = ttm.HIST_BUCKET_BOUNDS
PKGS = (("port", tfm, tfleet, ttm), ("ref", jfm, jfleet, jtm))


@pytest.fixture(autouse=True)
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


def _registries_equal():
    port, ref = ttm.snapshot(), jtm.snapshot()
    for k in ("counters", "gauges", "histograms"):
        assert port[k] == ref[k], k


def _hist_dump(samples):
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


class _Twin:
    """The port's and the reference's FleetMonitor over one dict of fake
    replicas and one clock; ``tick`` ticks both and asserts their
    documents equal."""

    def __init__(self, state, clock, rule="paid", **kw):
        def scrape(ep):
            st = state[ep]
            return {"counters": dict(st.get("counters", {})),
                    "gauges": dict(st.get("gauges", {})),
                    "histograms": {"server_ms{tier=paid}":
                                   _hist_dump(st["lat"])},
                    "bucket_bounds": list(BOUNDS)}

        self.mons = []
        for _name, fm, _fl, _tm in PKGS:
            args = dict(kw)
            args.setdefault("rules", [fm.SLORule(
                rule, "server_ms{tier=paid}", 0.99, 100.0)])
            self.mons.append(fm.FleetMonitor(
                endpoints=sorted(state), scrape_fn=scrape,
                now_fn=lambda: clock[0], interval_s=1.0,
                rate_window_s=30.0, fast_window_s=60.0,
                slow_window_s=600.0, burn_threshold=1.0, clear_ratio=0.5,
                **args))
        self.port = self.mons[0]

    def tick(self):
        port, ref = (m.tick() for m in self.mons)
        assert port == ref
        assert self.mons[0].alert_state == self.mons[1].alert_state
        return port

    def set_endpoints(self, eps):
        for m in self.mons:
            m.static_endpoints = list(eps)

    def autoscale_metrics(self, role=None):
        port, ref = (m.autoscale_metrics(role) for m in self.mons)
        assert port == ref
        return port


# -- SLO rules ---------------------------------------------------------------

RULE_SPECS = [
    "paid_server:server_ms{tier=paid}:p99:500;decode_itl:itl_ms:p99:250",
    "nonsense;also:bad",
    "a:ttft_ms:p50:20; ;b:x:q9:1;c:y:pz:3;d:itl_ms{model=m}:p90:7.5",
    "",
]


@pytest.mark.parametrize("spec", RULE_SPECS)
def test_parse_slo_rules_equal_the_reference(spec):
    port = [r.as_dict() for r in tfm.parse_slo_rules(spec)]
    assert port == [r.as_dict() for r in jfm.parse_slo_rules(spec)]


def test_parse_slo_rules():
    rules = tfm.parse_slo_rules(RULE_SPECS[0])
    assert [(r.name, r.metric, r.quantile, r.objective_ms)
            for r in rules] == [
        ("paid_server", "server_ms{tier=paid}", 0.99, 500.0),
        ("decode_itl", "itl_ms", 0.99, 250.0)]
    assert rules[0].matches("server_ms{tier=paid}")
    assert not rules[0].matches("server_ms{tier=free}")
    assert rules[1].matches("itl_ms{model=toy}")
    assert rules[1].matches("itl_ms")
    assert tfm.parse_slo_rules("nonsense;also:bad") == []
    # the default rules are the reference's flag
    assert [r.as_dict() for r in tfm.parse_slo_rules()] == \
        [r.as_dict() for r in jfm.parse_slo_rules()]


# -- FleetMonitor (tests/test_fleetmon.py:219-300) ---------------------------

def test_fleet_merged_p99_reflects_slow_replica():
    clock = [0.0]
    state = {"a": {"lat": [10.0] * 200}, "b": {"lat": [10.0] * 200}}
    twin = _Twin(state, clock)
    twin.tick()
    state["b"]["lat"] += [300.0] * 20
    clock[0] += 5.0
    doc = twin.tick()
    merged = doc["histograms"]["server_ms{tier=paid}"]
    union = state["a"]["lat"] + state["b"]["lat"]
    assert merged["count"] == len(union)
    assert merged["p99"] == _bucket_ub(_union_p(union, 0.99))
    assert merged["p99"] > 250.0
    rows = {r["endpoint"]: r for r in doc["replicas"]}
    assert rows["a"]["p99_ms"]["server_ms"] < 50.0
    _registries_equal()


def test_burn_alert_fires_and_clears_with_hysteresis():
    clock = [0.0]
    state = {"a": {"lat": [10.0] * 100}}
    twin = _Twin(state, clock)
    twin.tick()
    assert twin.port.alert_state["paid"] is False
    for _ in range(10):
        clock[0] += 5.0
        state["a"]["lat"] = state["a"]["lat"] + [400.0] * 20
        doc = twin.tick()
    slo = doc["slo"][0]
    assert slo["active"] is True
    assert slo["burn_fast"] >= 1.0 and slo["burn_slow"] >= 1.0
    snap = ttm.snapshot()
    assert snap["counters"]["slo_alerts_total{event=fire,slo=paid}"] == 1
    assert snap["gauges"]["slo_alert_active{slo=paid}"] == 1.0
    cleared_at = None
    for i in range(30):
        clock[0] += 5.0
        state["a"]["lat"] = state["a"]["lat"] + [10.0] * 50
        doc = twin.tick()
        if not doc["slo"][0]["active"]:
            cleared_at = i
            break
    assert cleared_at is not None
    snap = ttm.snapshot()
    assert snap["counters"]["slo_alerts_total{event=clear,slo=paid}"] == 1
    assert snap["counters"]["slo_alerts_total{event=fire,slo=paid}"] == 1
    _registries_equal()


def test_fleetmon_windowed_rates_and_goodput():
    clock = [0.0]
    state = {"a": {"lat": [1.0],
                   "counters": {"serving_deadline_met_total{tier=paid}": 0.0,
                                "serving_requests_total{model=fc}": 0.0,
                                "serving_tokens_generated_total": 0.0,
                                "serving_deadline_tokens_total{tier=paid}":
                                    0.0}}}
    twin = _Twin(state, clock)
    twin.tick()
    for _ in range(10):
        clock[0] += 1.0
        c = state["a"]["counters"]
        c["serving_requests_total{model=fc}"] += 8.0
        c["serving_deadline_met_total{tier=paid}"] += 6.0
        c["serving_tokens_generated_total"] += 40.0
        c["serving_deadline_tokens_total{tier=paid}"] += 30.0
        doc = twin.tick()
    gp = doc["goodput"]
    assert gp["raw_replies_per_s"] == pytest.approx(8.0)
    assert gp["replies_per_s"] == pytest.approx(6.0)
    assert gp["raw_tokens_per_s"] == pytest.approx(40.0)
    assert gp["tokens_per_s"] == pytest.approx(30.0)
    assert gp["replies_per_s"] < gp["raw_replies_per_s"]


def test_fleetmon_counter_reset_keeps_rates_sane():
    """A replica restart zeroes its counters mid-window: the rate never
    goes negative, and both packages agree on it."""
    clock = [0.0]
    state = {"a": {"lat": [1.0],
                   "counters": {"serving_tokens_generated_total": 0.0}}}
    twin = _Twin(state, clock)
    twin.tick()
    for k in range(8):
        clock[0] += 1.0
        c = state["a"]["counters"]
        c["serving_tokens_generated_total"] = \
            3.0 if k == 4 else c["serving_tokens_generated_total"] + 10.0
        doc = twin.tick()
        assert doc["rates"]["serving_tokens_generated_total"] >= 0.0


def test_fleetmon_scrape_failure_counted():
    clock = [0.0]

    def scrape(ep):
        raise ConnectionError("replica died")

    docs = []
    for _name, fm, _fl, _tm in PKGS:
        mon = fm.FleetMonitor(endpoints=["dead:1"], scrape_fn=scrape,
                              now_fn=lambda: clock[0], interval_s=1.0,
                              rules=[])
        docs.append(mon.tick())
    assert docs[0] == docs[1]
    assert docs[0]["replicas_up"] == 0
    assert docs[0]["replicas"][0]["up"] is False
    assert ttm.counter_total("fleet_scrape_errors_total") == 1.0
    _registries_equal()


def test_fleetmon_membership_change_drops_ring():
    clock = [0.0]
    state = {"a": {"lat": [1.0]}, "b": {"lat": [1.0]}}
    twin = _Twin(state, clock)
    twin.tick()
    assert set(twin.port._rings) == {"a", "b"}
    twin.set_endpoints(["a"])
    del state["b"]
    clock[0] += 1.0
    doc = twin.tick()
    assert set(twin.port._rings) == {"a"}
    assert [r["endpoint"] for r in doc["replicas"]] == ["a"]


def test_fleetmon_reads_the_endpoints_file(tmp_path):
    """The published file wins over the static list, roles and epoch
    included; a torn file falls back to the static list."""
    path = str(tmp_path / "eps.json")
    tfleet.write_endpoints_file(path, 7, ["a", "b"])
    state = {"a": {"lat": [2.0]}, "b": {"lat": [3.0]}, "c": {"lat": [4.0]}}
    clock = [0.0]
    twin = _Twin(state, clock, endpoints_file=path)
    twin.set_endpoints(["c"])
    doc = twin.tick()
    assert doc["epoch"] == 7
    assert [r["endpoint"] for r in doc["replicas"]] == ["a", "b"]
    assert {r["role"] for r in doc["replicas"]} == {"serve"}
    with open(path, "w") as f:
        f.write("{torn")
    clock[0] += 1.0
    doc = twin.tick()
    assert [r["endpoint"] for r in doc["replicas"]] == ["c"]


def test_fleetmon_publishes_the_fleet_doc_on_the_coordinator():
    """``__fleet__`` lands on the server's store, and only while this
    process coordinates."""
    class _Store:
        def __init__(self):
            self.vars = {}

        def set_var(self, name, arr):
            self.vars[name] = arr

    class _Fleet:
        coordinator = True
        endpoints = ["a"]
        live = {0}
        epoch = 3

        def is_coordinator(self):
            return self.coordinator

        def role_of(self, rank):
            return "serve"

    store, fleet = _Store(), _Fleet()
    mon = tfm.FleetMonitor(server=store, fleet=fleet,
                           scrape_fn=lambda ep: {"counters": {"x": 1.0}},
                           now_fn=lambda: 5.0, rules=[])
    doc = mon.tick()
    assert doc["epoch"] == 3 and doc["replicas_up"] == 1
    assert ttm.decode_snapshot(store.vars[tfm.FLEET_RPC_KEY]) == doc
    fleet.coordinator = False
    store.vars.clear()
    mon.tick()
    assert store.vars == {}


# -- the autoscaler (tests/test_fleetmon.py:300-372) --------------------------

def test_autoscaler_scrape_race_counted_and_logged_once(caplog):
    def racy_metrics():
        raise RuntimeError("endpoints flapped")

    for _name, _fm, fl, _tm in PKGS:
        sc = fl.AutoScaler(racy_metrics, lambda: None, lambda: None,
                           replicas_fn=lambda: 1, min_replicas=1,
                           max_replicas=2, up_ticks=2, down_ticks=2,
                           cooldown=1, up_depth=4.0, interval_s=10.0)
        with caplog.at_level(logging.WARNING):
            for _ in range(5):
                assert sc.tick() is None
    assert ttm.counter_total("autoscale_scrape_races_total") == 5.0
    races = [r for r in caplog.records if "raced" in r.getMessage()]
    assert len(races) == 2                # once for each package
    _registries_equal()


def _scalers(metrics_fn, replicas, **kw):
    """One AutoScaler per package over the same metrics -> (scalers,
    their event lists)."""
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    kw.setdefault("cooldown", 2)
    kw.setdefault("up_depth", 4.0)
    kw.setdefault("interval_s", 10.0)
    out, events = [], []
    for _name, _fm, fl, _tm in PKGS:
        ev = []
        out.append(fl.AutoScaler(
            metrics_fn, lambda ev=ev: ev.append("up"),
            lambda ev=ev: ev.append("down"),
            replicas_fn=lambda: replicas[0], **kw))
        events.append(ev)
    return out, events


def _tick(scalers):
    port, ref = (s.tick() for s in scalers)
    assert port == ref
    return port


def test_autoscaler_pressure_from_windowed_shed_rate():
    m = {"queue_depth": 0.0, "shed_total": 0.0, "shed_rate": 2.5}
    scs, _ev = _scalers(lambda: m, [2], down_ticks=2, cooldown=1)
    assert _tick(scs) is None
    assert _tick(scs) == "up"
    m["shed_rate"] = 0.0
    assert _tick(scs) is None
    assert _tick(scs) is None
    assert _tick(scs) == "down"
    _registries_equal()


def test_autoscaler_fleetmon_wiring():
    clock = [0.0]
    state = {"a": {"lat": [1.0], "counters": {"serving_shed_total": 0.0},
                   "gauges": {"serving_queue_depth": 0.0}},
             "b": {"lat": [1.0], "counters": {"serving_shed_total": 0.0},
                   "gauges": {"serving_queue_depth": 0.0}}}
    twin = _Twin(state, clock)
    assert twin.autoscale_metrics() is None
    twin.tick()
    for _ in range(5):
        clock[0] += 1.0
        state["a"]["counters"]["serving_shed_total"] += 3.0
        twin.tick()
    m = twin.autoscale_metrics()
    assert m["shed_rate"] == pytest.approx(3.0)
    assert m["replicas_up"] == 2
    assert twin.autoscale_metrics("serve") == m
    assert twin.autoscale_metrics("decode")["replicas_up"] == 0
    scs, _ev = _scalers(twin.port.autoscale_metrics, [1], down_ticks=2)
    assert _tick(scs) is None
    assert _tick(scs) == "up"


# -- the autoscaler (tests/test_serving_control.py:292-336) -------------------

class _Metrics:
    def __init__(self):
        self.depth = 0.0
        self.shed = 0.0

    def __call__(self):
        return {"queue_depth": self.depth, "shed_total": self.shed}


def test_autoscaler_blip_does_not_flap():
    m, replicas = _Metrics(), [1]
    scs, events = _scalers(m, replicas)
    m.depth = 10.0
    assert _tick(scs) is None
    m.depth = 0.0
    for _ in range(10):
        _tick(scs)
    assert events[0] == events[1] == []


def test_autoscaler_sustained_pressure_scales_up_once():
    m, replicas = _Metrics(), [1]
    scs, events = _scalers(m, replicas)
    m.depth = 10.0
    assert _tick(scs) is None
    assert _tick(scs) == "up"
    assert events[0] == ["up"]
    assert _tick(scs) is None and _tick(scs) is None
    assert events[0] == events[1] == ["up"]
    assert ttm.snapshot()["counters"].get(
        "autoscale_events_total{dir=up}") == 1
    assert scs[0].events == scs[1].events
    _registries_equal()


def test_autoscaler_clamps_and_scales_down():
    m, replicas = _Metrics(), [3]
    scs, events = _scalers(m, replicas)
    m.depth = 10.0
    for _ in range(5):
        _tick(scs)
    assert events[0] == []
    m.depth = 0.0
    _tick(scs)
    _tick(scs)
    assert _tick(scs) == "down"
    assert events[0] == ["down"]
    replicas[0] = 1
    for _ in range(10):
        _tick(scs)
    assert events[0] == events[1] == ["down"]


def test_autoscaler_shed_delta_is_pressure():
    m, replicas = _Metrics(), [1]
    scs, events = _scalers(m, replicas)
    _tick(scs)
    m.shed = 5.0
    assert _tick(scs) is None
    m.shed = 9.0
    assert _tick(scs) == "up"
    assert events[0] == events[1] == ["up"]


def test_autoscaler_pressure_fn_and_failing_action():
    """A role's own pressure rule replaces the default, and a scale
    action that raises is logged while the controller keeps going."""
    calls = []

    def pressure(m):
        return m["kv"] >= 0.85, m["kv"] <= 0.3

    def boom():
        calls.append(1)
        raise RuntimeError("fork failed")

    m = {"kv": 0.9}
    sc = tfleet.AutoScaler(lambda: m, boom, lambda: None,
                           replicas_fn=lambda: 1, min_replicas=1,
                           max_replicas=2, up_ticks=1, down_ticks=1,
                           cooldown=0, up_depth=4.0, interval_s=10.0,
                           pressure_fn=pressure)
    assert sc.tick() == "up" and calls == [1]
    m["kv"] = 0.5
    assert sc.tick() is None


def test_autoscaler_defaults_read_the_reference_flags():
    sc = tfleet.AutoScaler(lambda: {}, None, None, replicas_fn=lambda: 1)
    ref = jfleet.AutoScaler(lambda: {}, None, None, replicas_fn=lambda: 1)
    for k in ("min_replicas", "max_replicas", "up_ticks", "down_ticks",
              "cooldown_ticks", "up_depth", "interval_s"):
        assert getattr(sc, k) == getattr(ref, k), k
    sc.start()
    sc.stop()
    assert sc._thread is None
