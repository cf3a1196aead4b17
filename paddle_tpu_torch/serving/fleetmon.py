"""Fleet-wide metrics plane of the port: scrape -> merge -> window ->
alert.

Counterpart of ``paddle_tpu/serving/fleetmon.py``.  Every replica
republishes its telemetry snapshot under ``__metrics__`` once a second;
``FleetMonitor`` re-reads the endpoints file each tick (so membership
changes show without a restart), scrapes every live replica, and builds
one fleet document:

  * histograms merged exactly through the shared bucket vectors
    (``telemetry.merge_hist_snapshots``);
  * windowed rates (shed/s, tokens/s, requests/s) from reset-safe counter
    deltas over a per-endpoint history ring, dropped when an endpoint
    leaves the published view;
  * multi-window burn-rate SLO rules (``FLAGS_serving_slo_rules``,
    ``name:metric:pQQ:objective_ms`` joined by ``;``): an alert fires when
    the windowed percentile over both the fast and the slow window reaches
    ``FLAGS_serving_slo_burn_threshold`` times the objective, and clears
    with hysteresis when the fast burn drops below threshold x
    ``FLAGS_serving_slo_clear_ratio``;
  * goodput: replies and tokens that met their deadline per second, beside
    the raw rates.

The coordinator republishes the document under ``__fleet__``;
``autoscale_metrics`` is the ``AutoScaler``'s view of it.  ``scrape_fn``,
``now_fn`` and explicit ``endpoints`` make ``tick`` testable without
sockets or sleeps.
"""

import json
import logging
import os
import threading
import time

from ..core import telemetry as _tm

__all__ = ["FleetMonitor", "SLORule", "parse_slo_rules", "FLEET_RPC_KEY"]

FLEET_RPC_KEY = "__fleet__"


def _flag(name):
    from .. import flags

    return flags.flag(name)


def _family(flat):
    """``server_ms{tier=paid}`` -> ``server_ms`` (flat key -> family)."""
    return flat.split("{", 1)[0]


class SLORule:
    """One burn-rate rule: percentile ``quantile`` of histogram
    ``metric`` (a flat key like ``server_ms{tier=paid}`` for one label
    set, or a bare family name like ``itl_ms`` to merge every label
    set) against ``objective_ms``."""

    __slots__ = ("name", "metric", "quantile", "objective_ms")

    def __init__(self, name, metric, quantile, objective_ms):
        self.name = name
        self.metric = metric
        self.quantile = float(quantile)
        self.objective_ms = float(objective_ms)

    def matches(self, flat):
        if "{" in self.metric:
            return flat == self.metric
        return _family(flat) == self.metric

    def as_dict(self):
        return {"name": self.name, "metric": self.metric,
                "quantile": self.quantile,
                "objective_ms": self.objective_ms}


def parse_slo_rules(spec=None):
    """``FLAGS_serving_slo_rules`` syntax:
    ``name:metric:pQQ:objective_ms`` joined by ``;`` — e.g.
    ``paid_server:server_ms{tier=paid}:p99:500;decode_itl:itl_ms:p99:250``.
    Malformed entries are skipped with a warning (a typo in one rule
    must not take down the whole monitor)."""
    spec = spec if spec is not None else _flag("serving_slo_rules")
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 4 or not fields[2].startswith("p"):
            logging.warning("[fleetmon] skipping malformed SLO rule %r "
                            "(want name:metric:pQQ:objective_ms)", part)
            continue
        try:
            q = float(fields[2][1:]) / 100.0
            rules.append(SLORule(fields[0], fields[1], q,
                                 float(fields[3])))
        except ValueError:
            logging.warning("[fleetmon] skipping malformed SLO rule %r",
                            part)
    return rules


def _read_endpoints_doc(path):
    """The fleet's atomic endpoints file ->
    (endpoints, {endpoint: role}, epoch).  (client.read_endpoints_doc
    returns the client-routing shape; this one keys roles by endpoint
    and carries the epoch.)"""
    with open(path) as f:
        doc = json.load(f)
    eps = list(doc.get("endpoints") or [])
    roles = doc.get("roles") or []
    role_of = {ep: (roles[i] if i < len(roles) else "serve")
               for i, ep in enumerate(eps)}
    return eps, role_of, int(doc.get("epoch", 0))


class FleetMonitor:
    """Scrape/merge/alert loop.  Construct with either a live wiring
    (``server`` + ``fleet`` and/or ``endpoints_file``) or a test wiring
    (explicit ``endpoints`` + ``scrape_fn`` + ``now_fn``) and drive via
    ``start()`` or direct ``tick()`` calls."""

    def __init__(self, server=None, fleet=None, endpoints_file=None,
                 endpoints=None, interval_s=None, rate_window_s=None,
                 fast_window_s=None, slow_window_s=None,
                 burn_threshold=None, clear_ratio=None, rules=None,
                 scrape_fn=None, now_fn=None):
        self.server = server
        self.fleet = fleet
        self.endpoints_file = endpoints_file or \
            _flag("serving_endpoints_file") or None
        self.static_endpoints = list(endpoints) if endpoints else None
        self.interval_s = float(
            interval_s if interval_s is not None
            else _flag("serving_fleetmon_interval"))
        self.rate_window_s = float(
            rate_window_s if rate_window_s is not None
            else _flag("serving_rate_window"))
        self.fast_window_s = float(
            fast_window_s if fast_window_s is not None
            else _flag("serving_slo_fast_window"))
        self.slow_window_s = float(
            slow_window_s if slow_window_s is not None
            else _flag("serving_slo_slow_window"))
        self.burn_threshold = float(
            burn_threshold if burn_threshold is not None
            else _flag("serving_slo_burn_threshold"))
        self.clear_ratio = float(
            clear_ratio if clear_ratio is not None
            else _flag("serving_slo_clear_ratio"))
        self.rules = rules if rules is not None else parse_slo_rules()
        self._scrape = scrape_fn or \
            (lambda ep: _tm.scrape(ep, timeout=3.0))
        self._now = now_fn or time.time
        # per-endpoint history ring: [(t, {"counters": {flat: v},
        # "hists": {flat: cumulative-buckets}})] — windowed rates and
        # windowed bucket-delta percentiles both read from here
        self._rings = {}
        self._roles = {}
        self.alert_state = {r.name: False for r in self.rules}
        self.last = None              # last fleet doc (tick output)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- membership ----------------------------------------------------------

    def _is_coordinator(self):
        return self.fleet is None or self.fleet.is_coordinator()

    def _endpoints(self):
        """(endpoints, {endpoint: role}, epoch) for this tick — the
        endpoints file wins (it is the fleet's published truth and this
        re-read is what makes membership changes visible without a
        monitor restart), then the live fleet view, then the static
        test list."""
        if self.endpoints_file and os.path.exists(self.endpoints_file):
            try:
                return _read_endpoints_doc(self.endpoints_file)
            except (OSError, ValueError):
                pass                   # torn/missing file: fall through
        if self.fleet is not None:
            eps = [self.fleet.endpoints[r]
                   for r in sorted(self.fleet.live)]
            roles = {self.fleet.endpoints[r]: self.fleet.role_of(r)
                     for r in sorted(self.fleet.live)}
            return eps, roles, self.fleet.epoch
        eps = self.static_endpoints or []
        return eps, {ep: "serve" for ep in eps}, 0

    # -- ring math -----------------------------------------------------------

    def _record(self, ep, now, snap):
        ring = self._rings.setdefault(ep, [])
        ring.append((now, {
            "counters": dict(snap.get("counters") or {}),
            "hists": {flat: list(h.get("buckets") or [])
                      for flat, h in (snap.get("histograms")
                                      or {}).items()},
        }))
        # keep the slow window plus one pre-cut baseline sample
        cut = now - self.slow_window_s
        while len(ring) > 2 and ring[1][0] < cut:
            ring.pop(0)

    def _windowed_cum(self, ep, flat, now, window_s):
        """Cumulative bucket vector of ``flat``'s observations on ``ep``
        within the trailing window: the elementwise difference of two
        cumulative snapshots IS the window's cumulative vector.  A
        negative element means the replica restarted mid-window — the
        post-reset vector stands alone (Prometheus counter-reset
        rule)."""
        ring = self._rings.get(ep) or []
        pts = [(t, rec["hists"].get(flat)) for t, rec in ring]
        pts = [(t, v) for t, v in pts if v]
        if not pts:
            return None
        cut = now - window_s
        inside = [i for i, (t, _) in enumerate(pts) if t >= cut]
        if not inside:
            return None
        cur = pts[inside[-1]][1]
        base_i = inside[0] - 1
        if base_i < 0:
            return [int(c) for c in cur]
        base = pts[base_i][1]
        if len(base) != len(cur):
            return [int(c) for c in cur]
        delta = [int(c) - int(b) for c, b in zip(cur, base)]
        if any(d < 0 for d in delta):
            return [int(c) for c in cur]
        return delta

    def _rate(self, ep, flat, now, window_s=None):
        ring = self._rings.get(ep) or []
        pts = [(t, rec["counters"].get(flat, 0.0)) for t, rec in ring]
        return _tm.rate_from_samples(
            pts, window_s or self.rate_window_s, now=now)

    def windowed_percentile(self, rule, now, window_s, endpoints=None):
        """Fleet percentile of ``rule.metric`` over the trailing window:
        per-endpoint windowed cumulative vectors (all matching label
        sets) sum elementwise, then ``bucket_percentile``.  Returns
        (value_ms, observations)."""
        eps = endpoints if endpoints is not None else list(self._rings)
        merged = None
        for ep in eps:
            ring = self._rings.get(ep)
            if not ring:
                continue
            for flat in ring[-1][1]["hists"]:
                if not rule.matches(flat):
                    continue
                cum = self._windowed_cum(ep, flat, now, window_s)
                if cum is None:
                    continue
                if merged is None:
                    merged = list(cum)
                elif len(merged) == len(cum):
                    merged = [a + b for a, b in zip(merged, cum)]
        if not merged or merged[-1] <= 0:
            return 0.0, 0
        return _tm.bucket_percentile(merged, rule.quantile), \
            int(merged[-1])

    # -- one tick ------------------------------------------------------------

    def tick(self, now=None):
        """Scrape every live replica, rebuild the fleet doc, update burn
        gauges/alerts, republish.  Returns the doc (tests read it
        directly; ``self.last`` keeps it for the autoscaler)."""
        now = float(now if now is not None else self._now())
        eps, role_of, epoch = self._endpoints()
        snaps, rows = {}, []
        for ep in eps:
            try:
                snaps[ep] = self._scrape(ep)
            except Exception:
                _tm.inc("fleet_scrape_errors_total")
                continue
            self._record(ep, now, snaps[ep])
            self._roles[ep] = role_of.get(ep, "serve")
        # drop rings for endpoints no longer published (retired replicas
        # must not keep contributing stale windowed counts)
        for ep in list(self._rings):
            if ep not in role_of:
                self._rings.pop(ep, None)
                self._roles.pop(ep, None)
        rates = {}
        for ep in snaps:
            for flat in self._rings[ep][-1][1]["counters"]:
                rates[flat] = rates.get(flat, 0.0) + \
                    self._rate(ep, flat, now)
        merged_hists = self._merge_hists(snaps)
        counters = {}
        for snap in snaps.values():
            for flat, v in (snap.get("counters") or {}).items():
                counters[flat] = counters.get(flat, 0.0) + float(v)
        for ep in eps:
            rows.append(self._row(ep, role_of.get(ep, "serve"),
                                  snaps.get(ep)))
        doc = {
            "t": now,
            "epoch": epoch,
            "interval_s": self.interval_s,
            "rate_window_s": self.rate_window_s,
            "replicas": rows,
            "replicas_up": len(snaps),
            "histograms": merged_hists,
            "counters": counters,
            "rates": {k: round(v, 6) for k, v in rates.items()},
            "goodput": self._goodput(rates),
            "slo": self._eval_slo(now),
            "bucket_bounds": list(_tm.HIST_BUCKET_BOUNDS),
        }
        with self._lock:
            self.last = doc
        _tm.set_gauge("fleet_replicas_up", len(snaps))
        self._publish(doc)
        return doc

    def _merge_hists(self, snaps):
        keys = set()
        for snap in snaps.values():
            keys.update((snap.get("histograms") or {}))
        out = {}
        for flat in sorted(keys):
            out[flat] = _tm.merge_hist_snapshots(
                [(s.get("histograms") or {}).get(flat)
                 for s in snaps.values()])
        return out

    def _row(self, ep, role, snap):
        row = {"endpoint": ep, "role": role, "up": snap is not None}
        if snap is None:
            return row
        gauges = snap.get("gauges") or {}
        hists = snap.get("histograms") or {}

        def gmax(family):
            vals = [v for flat, v in gauges.items()
                    if _family(flat) == family]
            return max(vals) if vals else 0.0

        def p99(family):
            vals = [h.get("p99", 0.0) for flat, h in hists.items()
                    if _family(flat) == family]
            return max(vals) if vals else 0.0

        fill = [h for flat, h in hists.items()
                if _family(flat) == "serving_batch_fill"]
        row.update({
            "queue_depth": gauges.get("serving_queue_depth", 0.0),
            "batch_fill_p50": max([h.get("p50", 0.0) for h in fill]
                                  or [0.0]),
            "kv_occupancy": gmax("kv_pool_occupancy"),
            "prefix_hit_rate": gmax("prefix_cache_hit_rate"),
            "p99_ms": {f: p99(f) for f in ("server_ms", "ttft_ms",
                                           "itl_ms",
                                           "serving_execute_ms")},
            "shed_total": sum(
                v for flat, v in (snap.get("counters") or {}).items()
                if _family(flat) == "serving_shed_total"),
        })
        return row

    def _goodput(self, rates):
        def fam(name):
            return sum(v for flat, v in rates.items()
                       if _family(flat) == name)

        return {
            "replies_per_s": round(fam("serving_deadline_met_total"), 6),
            "raw_replies_per_s": round(fam("serving_requests_total"), 6),
            "missed_per_s": round(fam("serving_deadline_missed_total"),
                                  6),
            "tokens_per_s": round(fam("serving_deadline_tokens_total"),
                                  6),
            "raw_tokens_per_s": round(
                fam("serving_tokens_generated_total"), 6),
        }

    def _eval_slo(self, now):
        """Multi-window burn per rule + fire/clear hysteresis.  Burn =
        windowed percentile / objective; fire needs BOTH windows hot
        (fast catches the regression quickly, slow proves it is not a
        blip); clear needs the fast burn safely below threshold."""
        out = []
        for rule in self.rules:
            fast_p, fast_n = self.windowed_percentile(
                rule, now, self.fast_window_s)
            slow_p, slow_n = self.windowed_percentile(
                rule, now, self.slow_window_s)
            burn_fast = fast_p / rule.objective_ms
            burn_slow = slow_p / rule.objective_ms
            _tm.set_gauge("slo_burn_rate", burn_fast, slo=rule.name,
                          window="fast")
            _tm.set_gauge("slo_burn_rate", burn_slow, slo=rule.name,
                          window="slow")
            active = self.alert_state.get(rule.name, False)
            if not active and fast_n > 0 \
                    and burn_fast >= self.burn_threshold \
                    and burn_slow >= self.burn_threshold:
                active = True
                _tm.inc("slo_alerts_total", slo=rule.name, event="fire")
                _tm.event("slo_alert", slo=rule.name, event="fire",
                          burn_fast=round(burn_fast, 4),
                          burn_slow=round(burn_slow, 4))
                logging.warning(
                    "[fleetmon] SLO %s FIRING: %s %s=%.1fms burn "
                    "fast=%.2f slow=%.2f (objective %.0fms)", rule.name,
                    rule.metric, "p%d" % round(rule.quantile * 100),
                    fast_p, burn_fast, burn_slow, rule.objective_ms)
            elif active and burn_fast < \
                    self.burn_threshold * self.clear_ratio:
                active = False
                _tm.inc("slo_alerts_total", slo=rule.name, event="clear")
                _tm.event("slo_alert", slo=rule.name, event="clear",
                          burn_fast=round(burn_fast, 4))
                logging.warning("[fleetmon] SLO %s cleared (fast burn "
                                "%.2f)", rule.name, burn_fast)
            self.alert_state[rule.name] = active
            _tm.set_gauge("slo_alert_active", 1.0 if active else 0.0,
                          slo=rule.name)
            d = rule.as_dict()
            d.update({"burn_fast": round(burn_fast, 4),
                      "burn_slow": round(burn_slow, 4),
                      "p_fast_ms": round(fast_p, 3),
                      "p_slow_ms": round(slow_p, 3),
                      "samples_fast": fast_n, "samples_slow": slow_n,
                      "active": active})
            out.append(d)
        return out

    def _publish(self, doc):
        """Republish the fleet doc under ``__fleet__`` on this process's
        RPC server (coordinator only — followers still aggregate for
        their local autoscaler view but do not claim the fleet key)."""
        if self.server is None or not self._is_coordinator():
            return
        try:
            import numpy as np

            buf = json.dumps(doc, default=str).encode("utf-8")
            rpc = getattr(self.server, "rpc", self.server)
            rpc.set_var(FLEET_RPC_KEY,
                        np.frombuffer(buf, dtype=np.uint8).copy())
        except Exception:
            pass                       # server shutting down under us

    # -- control-plane consumers ---------------------------------------------

    def autoscale_metrics(self, role=None):
        """The AutoScaler's ``metrics_fn`` view, sourced from the LAST
        fleet doc: fleet-summed queue depth (optionally one role's),
        lifetime shed total, and — the windowed upgrade over the
        one-tick shed delta — shed/s over the rate window.  Returns
        None when no doc exists yet (caller falls back to local
        instants)."""
        with self._lock:
            doc = self.last
        if doc is None:
            return None
        rows = [r for r in doc["replicas"]
                if r.get("up") and (role is None or r["role"] == role)]
        eps = [r["endpoint"] for r in rows]
        now = doc["t"]
        shed_rate = sum(
            self._rate(ep, flat, now)
            for ep in eps
            for flat in ((self._rings.get(ep) or [(0, {"counters": {}})])
                         [-1][1]["counters"])
            if _family(flat) == "serving_shed_total")
        return {
            "queue_depth": sum(r.get("queue_depth", 0.0) for r in rows),
            "shed_total": sum(r.get("shed_total", 0.0) for r in rows),
            "shed_rate": shed_rate,
            "kv_occupancy": max([r.get("kv_occupancy", 0.0)
                                 for r in rows] or [0.0]),
            "replicas_up": len(rows),
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    logging.exception("[fleetmon] tick failed")

        self._thread = threading.Thread(target=loop, name="fleetmon",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
