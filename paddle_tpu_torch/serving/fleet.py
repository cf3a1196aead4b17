"""Elastic serving replicas of the port: fleet membership over the
serving RPC port.

Counterpart of ``paddle_tpu/serving/fleet.py`` (``ServingFleet``,
``AutoScaler``, ``write_endpoints_file``), with the same keys, JSON file
and telemetry, so a fleet may mix replicas of both packages:

- every replica heartbeats the coordinator (the lowest live rank) with
  ``__fhb__<rank>`` on the coordinator's serving port; the heartbeats
  ride the same event stream as requests, so the server's poll loop runs
  the eviction checks (``tick``) with no extra socket;
- a replica silent for ``FLAGS_serving_hb_timeout`` is marked dead and a
  shrunken view is staged; the view is published (the ``__fview__`` var
  and the endpoints file, by atomic rename, at a bumped epoch) only when
  neither the serving engine nor the decode engine is ``in_batch``, so a
  membership change never lands mid-batch or mid-step;
- when the coordinator dies, the next-lowest live rank notices its
  heartbeats failing ``_PROMOTE_AFTER`` times, probes every lower rank,
  and promotes itself; a relaunched rank re-announces itself by its
  heartbeats and rejoins;
- after each heartbeat a follower reads the coordinator's ``__fview__``
  and takes its live set (``_adopt_view``), which the reference's
  followers do not: a prefill replica then picks its decode peers among
  the live ones, not among every slot of the list.

A ``roles`` column (serve|prefill|decode a rank, ``serving/disagg.py``)
rides the endpoints file and the ``__fview__`` / ``__fleet__`` views;
``live_role_endpoints`` is where a prefill replica picks its decode peer.
``tools/torch_serve.py --autoscale`` runs one ``AutoScaler`` a role of
that column, as the reference's replica does; ``standby_slot`` and
``retire_candidate`` pick the slots a controller may touch, its role's
alone.
"""

import json
import logging
import os
import threading

import numpy as np

from ..core import telemetry as _tm
from ..distributed.ps import HeartBeatMonitor
from ..native import rpc as _rpc
from . import codec

__all__ = ["ServingFleet", "AutoScaler", "FLEET_HB", "FLEET_VIEW",
           "standby_slot", "retire_candidate"]

FLEET_HB = "__fhb__"
FLEET_VIEW = "__fview__"
_PROMOTE_AFTER = 4  # consecutive heartbeat failures before probing


def _flag(name):
    from .. import flags

    return flags.flag(name)


def write_endpoints_file(path, epoch, endpoints, rollout=None, roles=None):
    """Atomic (tmp + rename) so client reads never see a torn view.  The
    optional rollout doc rides along so a version flip is published in
    the SAME epoch bump as any membership change.  ``roles`` is the
    disaggregation column: a list parallel to ``endpoints`` of
    "serve" | "prefill" | "decode" — absent means every replica is a
    monolith (pre-disagg files stay readable, and old clients ignore
    the extra key)."""
    doc = {"epoch": int(epoch), "endpoints": list(endpoints)}
    if rollout:
        doc["rollout"] = rollout
    if roles:
        doc["roles"] = list(roles)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def standby_slot(fleet, taken=(), role=None):
    """The slot a scale-up forks a standby into: the lowest rank that is
    neither live nor ``taken`` (a standby still starting there), of
    ``role`` when given -> a rank, or None."""
    busy = set(fleet.live) | set(taken)
    dead = [r for r in range(len(fleet.endpoints)) if r not in busy
            and (role is None or fleet.role_of(r) == role)]
    return dead[0] if dead else None


def retire_candidate(fleet, role=None):
    """The rank a scale-down retires: the highest live rank other than
    this replica (the coordinator), of ``role`` when given -> a rank, or
    None."""
    cands = [r for r in sorted(fleet.live) if r != fleet.rank
             and (role is None or fleet.role_of(r) == role)]
    return cands[-1] if cands else None


class ServingFleet:
    def __init__(self, rank, endpoints, server, endpoints_file=None,
                 roles=None):
        self.rank = int(rank)
        self.endpoints = list(endpoints)
        # the role column, parallel to endpoints; None keeps every rank a
        # monolith and the published file without a roles key
        if roles is not None and len(roles) != len(self.endpoints):
            raise ValueError("fleet roles column must parallel endpoints:"
                             " %d roles for %d endpoints"
                             % (len(roles), len(self.endpoints)))
        self.roles = list(roles) if roles is not None else None
        self.server = server                     # ServingServer
        self.endpoints_file = endpoints_file or \
            _flag("serving_endpoints_file") or None
        self.epoch = 0
        self.live = set(range(len(self.endpoints)))
        self.mon = None                          # coordinator only
        self._coord_rank = min(self.live)
        self._hb_thread = None
        self._tick_thread = None
        self._stop = threading.Event()
        self._hb_failures = 0
        self._lock = threading.Lock()
        self._pending_view = False
        self.rollout_doc = None         # published beside the endpoints
        self._retiring = set()          # ranks draining out (autoscaler)

    def is_coordinator(self):
        return self._coord_rank == self.rank

    def role_of(self, rank):
        if self.roles is None:
            return "serve"
        return self.roles[rank]

    def live_role_endpoints(self, role):
        """The live endpoints of ``role`` (a prefill replica's decode-peer
        pick)."""
        return [self.endpoints[r] for r in sorted(self.live)
                if self.role_of(r) == role]

    def live_role_ranks(self, role):
        return [r for r in sorted(self.live) if self.role_of(r) == role]

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self.server.attach_fleet(self)
        if self.is_coordinator():
            self._become_coordinator(initial=True)
        else:
            self.server.set_alive(self.epoch, False)
        self._start_heartbeat()
        return self

    def _become_coordinator(self, initial=False):
        timeout = float(_flag("serving_hb_timeout") or 2.0)
        if not initial:
            # promotion: rebuild liveness from a fresh probe of the list
            self.live = {r for r, ep in enumerate(self.endpoints)
                         if r == self.rank
                         or _rpc.probe(ep, key=codec.ALIVE_KEY,
                                       timeout=1.0) is not None}
            self.epoch += 1
            _tm.inc("serving_fleet_promotions_total")
            logging.warning("[serving-fleet] rank %d promoted to "
                            "coordinator (live=%s)", self.rank,
                            sorted(self.live))
        self._coord_rank = self.rank
        self.mon = HeartBeatMonitor(
            0, timeout_s=timeout, name="serving-fleet",
            worker_ids=sorted(self.live - {self.rank}))
        self.server.set_alive(self.epoch, True)
        self._publish_view()
        # heartbeats only wake the poll loop while peers are alive; a
        # self-tick keeps eviction checks running even with a silent fleet
        if self._tick_thread is None:
            self._tick_thread = threading.Thread(
                target=self._self_tick, name="fleet-tick", daemon=True)
            self._tick_thread.start()

    def _self_tick(self):
        interval = float(_flag("serving_hb_interval") or 0.3)
        me = self.endpoints[self.rank]
        while not self._stop.wait(interval):
            if not self.is_coordinator():
                continue
            try:
                c = _rpc.RpcClient(me, connect_timeout=1.0,
                                   rpc_deadline=2.0, retry_times=0)
                try:
                    c.send_var(FLEET_HB + str(self.rank),
                               np.asarray([self.rank], np.int64))
                finally:
                    c.close()
            except Exception:
                pass

    def _start_heartbeat(self):
        def loop():
            interval = float(_flag("serving_hb_interval") or 0.3)
            client = None
            while not self._stop.wait(interval):
                if self.is_coordinator():
                    continue
                try:
                    if client is None:
                        client = _rpc.RpcClient(
                            self.endpoints[self._coord_rank],
                            connect_timeout=1.0, rpc_deadline=2.0,
                            retry_times=0)
                    client.send_var(FLEET_HB + str(self.rank),
                                    np.asarray([self.rank], np.int64))
                    self._hb_failures = 0
                except Exception:
                    client = None
                    self._hb_failures += 1
                    if self._hb_failures >= _PROMOTE_AFTER:
                        self._hb_failures = 0
                        self._coordinator_lost()
                    continue
                try:
                    self._adopt_view(client.get_var(FLEET_VIEW))
                except Exception:  # read again on the next beat
                    client = None

        self._hb_thread = threading.Thread(target=loop, name="fleet-hb",
                                           daemon=True)
        self._hb_thread.start()

    def _adopt_view(self, view):
        """A follower takes the coordinator's published ``[epoch] +
        ranks`` (newer epochs only, itself always live), so its role
        picks (a prefill replica's decode peer) skip evicted and retired
        ranks and count a joined standby."""
        epoch = int(view[0])
        if epoch >= self.epoch and not self.is_coordinator():
            self.epoch = epoch
            self.live = {int(r) for r in view[1:]} | {self.rank}

    def _coordinator_lost(self):
        """The coordinator stopped answering: lowest live rank takes over."""
        for r in sorted(self.live):
            if r == self.rank:
                break
            if r == self._coord_rank:
                continue
            if _rpc.probe(self.endpoints[r], key=codec.ALIVE_KEY,
                          timeout=1.0) is not None:
                self.live.discard(self._coord_rank)
                self._coord_rank = r
                return
        self.live.discard(self._coord_rank)
        self._become_coordinator()

    # -- event stream (called from the server poll loop) ---------------------

    def on_event(self, name, arr):
        if name.startswith(FLEET_HB) and self.mon is not None:
            r = int(arr[0])
            if r in self.live:
                self.mon.update(r)
            elif r != self.rank and r not in self._retiring:
                # a relaunched/late replica re-announces itself (a
                # RETIRING rank's last heartbeats must NOT re-add it —
                # the set clears when the autoscaler reuses the slot)
                self.live.add(r)
                self.mon.update(r)
                with self._lock:
                    self._pending_view = True

    def tick(self):
        """Eviction check + deferred view publication.  Runs on the poll
        loop after every event AND on the engine's batch-boundary hook, so
        a shrink always lands between batches."""
        if not self.is_coordinator() or self.mon is None:
            return
        dead = [r for r in self.mon.check() if r in self.live]
        if dead:
            for r in dead:
                self.live.discard(r)
                self.mon.remove(r)
            self.epoch += 1
            _tm.inc("serving_fleet_evictions_total", len(dead))
            _tm.event("serving_fleet_evict", dead=dead, epoch=self.epoch,
                      live=sorted(self.live),
                      roles=[self.role_of(r) for r in dead])
            logging.warning("[serving-fleet] epoch %d: evicted %s (%s), "
                            "live=%s", self.epoch, dead,
                            ",".join(self.role_of(r) for r in dead),
                            sorted(self.live))
            with self._lock:
                self._pending_view = True
        publish = False
        with self._lock:
            if self._pending_view and not self._in_batch():
                self._pending_view = False
                publish = True
        if publish:
            self._publish_view()

    def _in_batch(self):
        """True while either engine of the server runs a batch or a
        decode step."""
        dec = getattr(self.server, "decode_engine", None)
        return self.server.engine.in_batch or (
            dec is not None and dec.in_batch)

    def _publish_view(self):
        ranks = sorted(self.live)
        live_eps = [self.endpoints[r] for r in ranks]
        live_roles = [self.role_of(r) for r in ranks] \
            if self.roles is not None else None
        self.server.rpc.set_var(
            FLEET_VIEW,
            np.asarray([self.epoch] + ranks, np.int64))
        if self.endpoints_file:
            try:
                write_endpoints_file(self.endpoints_file, self.epoch,
                                     live_eps, rollout=self.rollout_doc,
                                     roles=live_roles)
            except OSError as e:
                logging.warning("[serving-fleet] endpoints file write "
                                "failed: %s", e)
        _tm.set_gauge("serving_fleet_size", len(self.live))
        _tm.set_gauge("serving_fleet_epoch", self.epoch)
        if self.roles is not None:
            for role in ("prefill", "decode", "serve"):
                n = sum(1 for r in ranks if self.role_of(r) == role)
                if n or role != "serve":
                    _tm.set_gauge("serving_fleet_role_size", n, role=role)

    # -- control plane (autoscaler / rollout) --------------------------------

    def publish_rollout(self, doc):
        """Version-routing change: ride the next epoch bump so every
        client re-reading the endpoints file sees it atomically with the
        membership view."""
        self.rollout_doc = doc
        self.epoch += 1
        with self._lock:
            self._pending_view = True
        self.tick()

    def retire(self, rank):
        """Graceful scale-down of one replica: drop it from the view
        FIRST (clients stop routing to it), then order it to drain and
        exit via ``__retire__``.  Its last heartbeats are ignored via
        the retiring set so it can't flap back in."""
        if rank == self.rank or rank not in self.live:
            return False
        self.live.discard(rank)
        self._retiring.add(rank)
        if self.mon is not None:
            self.mon.remove(rank)
        self.epoch += 1
        _tm.event("serving_fleet_retire", rank=rank, epoch=self.epoch,
                  role=self.role_of(rank))
        logging.warning("[serving-fleet] epoch %d: retiring rank %d (%s)",
                        self.epoch, rank, self.role_of(rank))
        with self._lock:
            self._pending_view = True
        self.tick()
        try:
            c = _rpc.RpcClient(self.endpoints[rank], connect_timeout=1.0,
                               rpc_deadline=3.0, retry_times=0)
            try:
                c.send_var(codec.RETIRE_KEY,
                           np.asarray([self.rank], np.int64))
            finally:
                c.close()
        except Exception:
            pass  # already dead: eviction bookkeeping is done anyway
        return True

    def notice_relaunch(self, rank):
        """The autoscaler reused a retired slot: accept its heartbeats
        again."""
        self._retiring.discard(rank)

    def view(self):
        v = {"epoch": self.epoch, "live": sorted(self.live),
             "coordinator": self._coord_rank,
             "retiring": sorted(self._retiring)}
        if self.roles is not None:
            v["roles"] = {r: self.role_of(r) for r in sorted(self.live)}
        return v

    def stop(self):
        self._stop.set()


class AutoScaler:
    """Replica-count controller (coordinator-side).

    Watches queue depth and shed rate (``metrics_fn``: a closure over the
    engine gauges and scraped peers, or ``FleetMonitor.autoscale_metrics``,
    or in tests any stub) and drives ``scale_up_fn`` / ``scale_down_fn``
    (``tools/torch_serve.py --autoscale`` wires these to "fork a
    prewarmed standby into the lowest dead rank slot" and
    "fleet.retire(highest non-coordinator live rank)", as the reference's
    replica does).

    Flap protection is layered: PRESSURE must persist for
    ``FLAGS_serving_scale_up_ticks`` consecutive observations (and idle
    for ``FLAGS_serving_scale_down_ticks``) before acting, any event
    starts a ``FLAGS_serving_autoscale_cooldown``-tick refractory
    window, and the replica count is clamped to
    [FLAGS_serving_min_replicas, FLAGS_serving_max_replicas].  A
    one-tick metrics blip therefore never moves the fleet — the unit
    tests assert exactly that."""

    def __init__(self, metrics_fn, scale_up_fn, scale_down_fn,
                 replicas_fn, min_replicas=None, max_replicas=None,
                 up_ticks=None, down_ticks=None, cooldown=None,
                 up_depth=None, interval_s=None, pressure_fn=None):
        self.metrics_fn = metrics_fn
        self.scale_up_fn = scale_up_fn
        self.scale_down_fn = scale_down_fn
        self.replicas_fn = replicas_fn
        # role-specific pressure signal: callable(metrics) -> (pressure,
        # idle) booleans, replacing the default queue-depth/shed-delta
        # rule — a disaggregated fleet runs one AutoScaler per role
        # (prefill keyed on queue depth / TTFT, decode on KV-pool
        # occupancy / ITL) with everything else (streaks, cooldown,
        # clamps) shared
        self.pressure_fn = pressure_fn

        def _default(v, flag, cast):
            return cast(v if v is not None else _flag(flag))

        self.min_replicas = _default(min_replicas,
                                     "serving_min_replicas", int)
        self.max_replicas = _default(max_replicas,
                                     "serving_max_replicas", int)
        self.up_ticks = _default(up_ticks, "serving_scale_up_ticks", int)
        self.down_ticks = _default(down_ticks,
                                   "serving_scale_down_ticks", int)
        self.cooldown_ticks = _default(cooldown,
                                       "serving_autoscale_cooldown", int)
        self.up_depth = _default(up_depth, "serving_scale_up_depth", float)
        self.interval_s = _default(interval_s,
                                   "serving_autoscale_interval", float)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self._last_shed = None
        self._race_logged = False
        self.events = []                # ("up"|"down", tick_no) history
        self._ticks = 0
        self._stop = threading.Event()
        self._thread = None

    def tick(self):
        """One observation -> maybe one scaling event.  Returns
        "up" | "down" | None (tests drive this directly)."""
        self._ticks += 1
        try:
            m = self.metrics_fn() or {}
        except Exception:
            # scrape raced a membership change: the tick is skipped, but
            # a flapping endpoints file must not read as an unexplained
            # scaling stall — count every race, log the first
            _tm.inc("autoscale_scrape_races_total")
            if not self._race_logged:
                self._race_logged = True
                logging.warning("[autoscale] metrics scrape raced a "
                                "membership change; skipping tick "
                                "(counted in autoscale_scrape_races_total,"
                                " logged once)")
            return None
        depth = float(m.get("queue_depth", 0.0))
        shed = float(m.get("shed_total", 0.0))
        shed_delta = 0.0 if self._last_shed is None \
            else max(shed - self._last_shed, 0.0)
        self._last_shed = shed
        if self._cooldown > 0:
            # refractory window after an event: observe (the shed
            # baseline above keeps advancing) but never act or build
            # streaks, so one overload burst maps to ONE scale-up
            self._cooldown -= 1
            self._up_streak = self._down_streak = 0
            return None
        if self.pressure_fn is not None:
            pressure, idle = self.pressure_fn(m)
        else:
            # a fleet-windowed shed rate (shed/s over the rate window,
            # from FleetMonitor) subsumes the local one-tick shed delta:
            # it survives replica restarts and catches sheds on peers
            # the coordinator's own counter never sees
            if "shed_rate" in m:
                shedding = float(m.get("shed_rate", 0.0)) > 0.0
            else:
                shedding = shed_delta > 0.0
            pressure = depth >= self.up_depth or shedding
            idle = depth <= 0.0 and not shedding
        if pressure:
            self._up_streak += 1
            self._down_streak = 0
        elif idle:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        n = int(self.replicas_fn())
        if self._up_streak >= self.up_ticks and n < self.max_replicas:
            self._fire("up", self.scale_up_fn)
            return "up"
        if self._down_streak >= self.down_ticks and n > self.min_replicas:
            self._fire("down", self.scale_down_fn)
            return "down"
        return None

    def _fire(self, direction, fn):
        self._up_streak = self._down_streak = 0
        self._cooldown = self.cooldown_ticks
        self.events.append((direction, self._ticks))
        _tm.inc("autoscale_events_total", dir=direction)
        _tm.event("autoscale", dir=direction, tick=self._ticks)
        logging.warning("[autoscale] scale %s at tick %d", direction,
                        self._ticks)
        try:
            fn()
        except Exception:
            logging.exception("[autoscale] scale_%s failed", direction)

    def start(self):
        def loop():
            while not self._stop.wait(self.interval_s):
                self.tick()

        self._thread = threading.Thread(target=loop, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
