"""Metrics-gated canary rollout of versioned models on the port.

Counterpart of ``paddle_tpu/serving/rollout.py``.  A new version is
registered beside the old one (``bert@v2`` next to ``bert``) and
prewarmed, so a flip is a routing change, not a restart.  The
coordinator's ``RolloutController`` owns the state machine per base name:

  stable -> canary (``start``: a hash-deterministic fraction of the
            requests lands on the new version; ``ServingEngine.resolve``
            does the split)
         -> flipped (``flip``: all of them)
         -> rolled_back (``abort``, or the metrics gate tripping)

The gate compares the canary's stats with the active version's across
every live replica: p99 of ``serving_execute_ms{model}`` (from merged
bucket vectors where every replica has them) and the error rate of
``serving_request_errors_total{model}`` over
``serving_requests_total{model}``.  ``evaluate_gate`` is pure.

Every change is applied locally, sent to the live peers as an idempotent
``__rollout_set__``, and published in the fleet's epoch-bumped endpoints
file; the monitor thread re-broadcasts, so a replica that missed a change
(relaunched, or the send raced its death) converges within an interval.
"""

import logging
import threading

from ..core import telemetry as _tm
from ..native import rpc as _rpc
from . import codec

__all__ = ["RolloutController", "evaluate_gate", "stats_from_snapshot",
           "merge_stats"]


def _flag(name):
    from .. import flags

    return flags.flag(name)


# -- gate (pure, unit-testable) ----------------------------------------------

def stats_from_snapshot(snap, model):
    """Per-version stats out of one replica's telemetry snapshot:
    {count, errors, p99_ms} for ``model`` (a version name, e.g. fc@v2)."""
    hist = (snap.get("histograms") or {}).get(
        "serving_execute_ms{model=%s}" % model) or {}
    counters = snap.get("counters") or {}
    errors = 0.0
    requests = 0.0
    for flat, v in counters.items():
        if flat.startswith("serving_request_errors_total{") \
                and "model=%s" % model in flat:
            errors += v
        elif flat.startswith("serving_requests_total{") \
                and "model=%s," % model in flat:
            requests += v
    out = {"count": float(hist.get("count", 0.0)) + errors,
           "requests": requests,
           "errors": errors,
           "p99_ms": float(hist.get("p99", 0.0))}
    # the cumulative bucket vector rides along so merge_stats can compute
    # a fleet-exact p99 instead of the worst replica's; a snapshot
    # without one keeps the worst-replica fallback
    if hist.get("buckets"):
        out["buckets"] = list(hist["buckets"])
    return out


def merge_stats(per_replica):
    """Fold per-replica stats: counts/errors sum.  When every replica
    shipped a cumulative bucket vector the merged p99 is computed from
    the summed buckets — exact to within one bucket width across the
    whole fleet.  Any bucket-less entry (old replica mid-rollout) drops
    the merge back to the conservative fallback: p99 takes the WORST
    replica (a canary that is slow anywhere trips)."""
    out = {"count": 0.0, "requests": 0.0, "errors": 0.0, "p99_ms": 0.0}
    merged_buckets = None
    exact = True
    for s in per_replica:
        out["count"] += s.get("count", 0.0)
        out["requests"] += s.get("requests", 0.0)
        out["errors"] += s.get("errors", 0.0)
        out["p99_ms"] = max(out["p99_ms"], s.get("p99_ms", 0.0))
        b = s.get("buckets")
        if not b:
            exact = False
            continue
        deltas = _tm.cumulative_to_deltas(b)
        if merged_buckets is None:
            merged_buckets = deltas
        else:
            merged_buckets = [a + d for a, d in zip(merged_buckets, deltas)]
    if exact and merged_buckets is not None and sum(merged_buckets) > 0:
        cum, run = [], 0
        for d in merged_buckets:
            run += d
            cum.append(run)
        out["p99_ms"] = _tm.bucket_percentile(cum, 0.99)
        out["buckets"] = cum
    return out


def evaluate_gate(canary, baseline, p99_ratio=None, error_rate=None,
                  min_samples=None):
    """Canary-vs-active verdict: {"verdict": pass|trip|insufficient,
    "reason": ...}.  Trips when the canary's error rate exceeds
    ``error_rate`` or its p99 exceeds ``p99_ratio`` x the active
    version's; below ``min_samples`` observed canary requests the gate
    abstains (a two-request blip must not roll back a fleet)."""
    p99_ratio = float(p99_ratio if p99_ratio is not None
                      else _flag("rollout_gate_p99_ratio"))
    error_rate = float(error_rate if error_rate is not None
                       else _flag("rollout_gate_error_rate"))
    min_samples = int(min_samples if min_samples is not None
                      else _flag("rollout_gate_min_samples"))
    seen = max(canary.get("count", 0.0), canary.get("requests", 0.0))
    if seen < min_samples:
        return {"verdict": "insufficient",
                "reason": "%d/%d canary samples" % (seen, min_samples)}
    denom = max(canary.get("requests", 0.0), canary.get("count", 0.0), 1.0)
    rate = canary.get("errors", 0.0) / denom
    if rate > error_rate:
        return {"verdict": "trip",
                "reason": "error rate %.3f > %.3f" % (rate, error_rate)}
    base_p99 = baseline.get("p99_ms", 0.0)
    if base_p99 > 0.0 and canary.get("p99_ms", 0.0) > p99_ratio * base_p99:
        return {"verdict": "trip",
                "reason": "p99 %.1fms > %.1fx baseline %.1fms"
                % (canary["p99_ms"], p99_ratio, base_p99)}
    return {"verdict": "pass",
            "reason": "error rate %.3f, p99 %.1fms vs baseline %.1fms"
            % (rate, canary.get("p99_ms", 0.0), base_p99)}


# -- controller --------------------------------------------------------------

class RolloutController:
    """Coordinator-side rollout state machine + gate monitor.

    ``handle`` serves the ``__rollout_ctl__`` admin commands (start /
    flip / abort / status); every mutation applies locally, broadcasts
    ``__rollout_set__`` to live peers, and publishes through the fleet's
    epoch-bumped endpoints file.  The monitor thread re-broadcasts (so
    missed flips converge) and auto-rolls-back a canary whose gate
    trips.  ``scrape_fn`` / ``snapshot_fn`` are injectable for tests."""

    def __init__(self, server, fleet=None, interval_s=0.5,
                 scrape_fn=None, snapshot_fn=None):
        self.server = server
        self.fleet = fleet
        self.interval_s = float(interval_s)
        self._scrape = scrape_fn or (lambda ep: _tm.scrape(ep, timeout=3.0))
        self._snapshot = snapshot_fn or _tm.snapshot
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.gate_verdicts = {}        # base -> last evaluate_gate result

    @property
    def engine(self):
        return self.server.engine

    def _is_coordinator(self):
        return self.fleet is None or self.fleet.is_coordinator()

    # -- admin commands ------------------------------------------------------

    def handle(self, cmd):
        """One admin command dict -> reply meta dict."""
        op = cmd.get("op")
        if not self._is_coordinator():
            return {"status": "error", "error": "not coordinator"}
        try:
            with self._lock:
                if op == "start":
                    base = cmd["model"]
                    fraction = float(
                        cmd.get("fraction")
                        or _flag("serving_canary_fraction"))
                    self.engine.set_route(
                        base, active=cmd["active"], canary=cmd["canary"],
                        fraction=fraction, state="canary")
                elif op == "flip":
                    base = cmd["model"]
                    route = self.engine.routes().get(base)
                    if route is None or not route.get("canary"):
                        raise ValueError("no canary staged for %r" % base)
                    self.engine.set_route(
                        base, active=route["canary"], canary=None,
                        fraction=0.0, state="flipped")
                elif op == "abort":
                    base = cmd["model"]
                    route = self.engine.routes().get(base)
                    if route is None:
                        raise ValueError("no rollout for %r" % base)
                    self.engine.set_route(
                        base, active=route["active"], canary=None,
                        fraction=0.0, state="rolled_back")
                elif op == "status":
                    return {"status": "ok",
                            "routes": self.engine.routes(),
                            "gates": dict(self.gate_verdicts)}
                else:
                    raise ValueError("unknown rollout op %r" % op)
        except (KeyError, ValueError) as e:
            return {"status": "error", "error": str(e)}
        _tm.event("rollout_" + op, model=cmd.get("model"),
                  routes=self.engine.routes())
        self.broadcast()
        return {"status": "ok", "routes": self.engine.routes()}

    # -- propagation ---------------------------------------------------------

    def broadcast(self):
        """Apply-locally + push ``__rollout_set__`` to every live peer +
        publish through the fleet (endpoints file, epoch bump).
        Idempotent — also the periodic convergence path."""
        doc = {"models": self.engine.routes()}
        self.server.apply_rollout(doc)
        if self.fleet is None:
            return
        buf = codec.pack(doc)
        for r in sorted(self.fleet.live):
            if r == self.fleet.rank:
                continue
            try:
                c = _rpc.RpcClient(self.fleet.endpoints[r],
                                   connect_timeout=1.0, rpc_deadline=3.0,
                                   retry_times=0)
                try:
                    c.send_var(codec.ROLLOUT_SET_KEY, buf)
                finally:
                    c.close()
            except Exception:
                pass  # dead peer: eviction + re-broadcast converge it
        self.fleet.publish_rollout(doc)

    # -- gate monitor --------------------------------------------------------

    def _gather(self, version):
        """Per-version stats folded across self + live peers."""
        per = [stats_from_snapshot(self._snapshot(), version)]
        if self.fleet is not None:
            for r in sorted(self.fleet.live):
                if r == self.fleet.rank:
                    continue
                try:
                    per.append(stats_from_snapshot(
                        self._scrape(self.fleet.endpoints[r]), version))
                except Exception:
                    continue
        return merge_stats(per)

    def check_gates(self):
        """One monitor pass: evaluate every live canary, roll back on a
        trip.  Returns {base: verdict dict} (tests call it directly)."""
        out = {}
        for base, route in self.engine.routes().items():
            if route.get("state") != "canary" or not route.get("canary"):
                continue
            verdict = evaluate_gate(self._gather(route["canary"]),
                                    self._gather(route["active"]))
            out[base] = self.gate_verdicts[base] = verdict
            if verdict["verdict"] == "trip":
                logging.warning("[rollout] gate TRIPPED for %s: %s — "
                                "rolling back", base, verdict["reason"])
                _tm.inc("rollout_rollbacks_total", model=base)
                _tm.event("rollout_rollback", model=base,
                          reason=verdict["reason"])
                with self._lock:
                    self.engine.set_route(
                        base, active=route["active"], canary=None,
                        fraction=0.0, state="rolled_back")
                self.broadcast()
        return out

    def _monitor(self):
        while not self._stop.wait(self.interval_s):
            if not self._is_coordinator():
                continue
            try:
                self.check_gates()
                if self.engine.routes():
                    self.broadcast()   # convergence re-broadcast
            except Exception:
                logging.exception("[rollout] monitor pass failed")

    def start(self):
        self._thread = threading.Thread(target=self._monitor,
                                        name="rollout-monitor", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
