"""RPC serving front end of the port: the wire protocol over
``native/rpc.py``.

Counterpart of ``paddle_tpu/serving/server.py`` (``ServingServer``), the
monolith ("serve") role.  One ``RpcServer`` per replica carries the
protocol (keys in ``codec.py``):

  ``__infer__:<req_id>``    inbound SEND: packed request for the
                            ``ServingEngine``; the reply is published as
                            ``__reply__:<req_id>``, which the client's GET
                            waits for (the transport parks a GET until its
                            var exists)
  ``__generate__:<id>``     inbound SEND: a prompt for the
                            ``DecodeEngine``; with ``stream`` each token is
                            published as ``__stream__:<id>:<k>``, and the
                            final reply lands on ``__reply__:<id>``; a
                            stream that ends "migrated" names the
                            destination in its last chunk
                            (``migrated_to``), so the client follows
                            without another read here: a retiring
                            replica may be gone by then
  ``__abort__:<id>``        inbound SEND: drop the sequence and free its KV
                            blocks (a client abandoning an attempt)
  ``__alive__``             [rank, epoch, is_coordinator]
  ``__metrics__``           the telemetry snapshot, republished every
                            second while ``FLAGS_telemetry`` is on
  ``__spec__:<model>``      each model's signature (both engines)
  ``__fhb__<rank>``         a fleet replica's heartbeat, handed to the
                            attached ``ServingFleet``
  ``__rollout__``           this replica's version routes (empty until a
                            ``__rollout_set__`` arrives)
  ``__rollout_set__``       adopt a route table (``apply_rollout``)
  ``__rollout_ctl__:<id>``  an admin command for the ``RolloutController``
                            (``self.rollout``); the reply lands on
                            ``__reply__:<id>``
  ``__retire__``            drain both engines, then call ``on_retire``;
                            with ``FLAGS_migrate_on_drain`` the decode
                            drain pushes live sessions to peers
                            (``serving/migrate.py``)
  ``__resume__:<id>``       a client's crash resume: prompt + the tokens it
                            holds; the verdict lands on
                            ``__resumeack__:<id>``
  ``__kvxfer__:<id>``       sealed-block, commit and cancel frames of a
                            disaggregated pair, and a migration's block,
                            tail and session frames
  ``__pair__:<id>``         a prefill replica's routing hint: the decode
                            endpoint that streams the reply, or None

Replies and stream chunks join a FIFO ring of ``_REPLY_RING`` keys, the
oldest deleted past it, so clients that never read cannot grow the store.
With a fleet attached (``attach_fleet``), the fleet ticks after every
inbound frame and at both engines' batch boundaries.

Tracing (``core/tracing.py``, inert unless ``FLAGS_tracing``): an
``__infer__`` or ``__generate__`` opens its ``serving.admission`` span
under the request meta's ``traceparent`` (the client's root span), and the
engine's ``serving.request`` span opens inside it; each reply is published
inside a ``serving.reply_publish`` span under the request span, and its
meta echoes the ``traceparent``.  The fault points ``serving.infer`` and
``serving.generate`` (on arrival) and ``serving.reply`` (on publishing)
map as the reference maps them: ``drop`` loses the frame or the reply (the
client's GET times out and it replays), ``error`` answers with an
"injected fault: <point>" error reply.

``__rollout_ctl__:<id>`` on a server without a controller gets the
reference's "replica has no rollout controller" error reply.

Roles (``role=``, ``serving/disagg.py``), as in the reference: a
``prefill`` replica answers ``__generate__`` by picking a decode peer
(the fleet's live decode endpoints, else ``decode_peers``), sending it
an expect frame, publishing ``__pair__:<id>`` and running the handoff
prefill, whose sealed blocks stream to the peer and whose commit frame
hands it the request; without a reachable peer it publishes
``{"decode": None}`` and serves the request itself.  A ``decode``
replica adopts inbound blocks, serves committed requests (their reply
phases carry the prefill half's times, ``xfer_ms`` and ``role``
"disagg"), and reaps the adoptions of a dead prefill half (its
``AdoptTracker``).  Either role serves monolith traffic too.  A client's
``__abort__`` frees both halves: the prefill side relays a cancel, the
decode side forgets uncommitted adoptions.

Session migration (``FLAGS_session_migration``, ``serving/migrate.py``):
the server keeps a ``SessionMigrator`` (its peers: the fleet's live
decode and serve endpoints other than itself, else ``decode_peers``)
and a ``ResumeBuffer``; it adopts a migration's blocks, resumes its
session frame or a client's ``__resume__`` through the ordinary submit
and acks under ``__resumeack__:<id>``.  ``FLAGS_migrate_on_pressure``
pushes preempted sequences to the least-loaded peer.  Spans
``serving.adopt_commit`` and ``serving.resume``; notes ``kvxfer``,
``kvxfer_reject``, ``kvxfer_orphan`` and ``migrate``; counters
``kv_xfer_*``, ``kv_migrate_*``, ``serving_handoff_total`` and
``serving_handoff_fallback_total``, the reference's.
"""

import logging
import threading
import time
from collections import OrderedDict

import numpy as np

from .. import flags
from ..core import telemetry as _tm
from ..core import tracing as _tr
from ..native.rpc import EV_SEND, RpcServer
from ..utils.fault_injection import maybe_fail
from . import codec
from .disagg import AdoptTracker, KVBlockSender
from .engine import InferReply
from .migrate import ResumeBuffer, SessionMigrator

__all__ = ["ServingServer"]

_REPLY_RING = 1024

_log = logging.getLogger(__name__)


class ServingServer:
    """``engine`` (a ``ServingEngine``) and optionally ``decode_engine`` (a
    ``DecodeEngine``) behind one RPC endpoint on ``port`` (0: any free
    one, then ``self.port``)."""

    def __init__(self, engine, port=0, rank=0, decode_engine=None,
                 role=None, decode_peers=None):
        self.role = role or "serve"
        if self.role not in ("serve", "prefill", "decode"):
            raise ValueError("serving role must be serve|prefill|decode, "
                             "got %r" % (role,))
        self.engine = engine
        self.decode_engine = decode_engine
        self.rank = int(rank)
        self.rpc = RpcServer(port=port)
        self.port = self.rpc.port
        self.on_retire = None          # called after a __retire__ drain
        self.fleet = None              # ServingFleet (attach_fleet)
        self.rollout = None            # RolloutController
        self.fleetmon = None           # FleetMonitor (tools/torch_serve.py)
        self._pub_stop = None          # the __metrics__ publisher
        self._retire_thread = None
        self._reply_keys = []
        self._reply_lock = threading.Lock()
        # req_id -> the peer a migrated session went to, from its reply,
        # for the stream's last chunk (at most _REPLY_RING kept)
        self._migrated_to = OrderedDict()
        self._thread = None
        self._stopped = threading.Event()
        # disaggregation: the prefill side's sender and pair registry, the
        # decode side's adoption tracker
        self._decode_peers_static = list(decode_peers or [])
        self._xfer = None              # KVBlockSender (prefill role)
        self._adopt = None             # AdoptTracker (decode role)
        self._pairs = {}               # req_id -> request entry (prefill)
        self._pair_lock = threading.Lock()
        self._pair_rr = 0
        # migration: the source's pusher, the destination's tail buffer
        self.migrator = None           # SessionMigrator
        self._resume_buf = None        # ResumeBuffer

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self.engine.start()
        self.rpc.set_var(codec.ALIVE_KEY,
                         np.asarray([self.rank, 0, 0], np.int64))
        # always published, so a GET of it never parks on a replica that
        # has seen no rollout
        self.rpc.set_var(codec.ROLLOUT_KEY, codec.pack({"models": {}}))
        for name in self.engine.models():
            self.rpc.set_var(codec.SPEC_KEY + name,
                             codec.pack(self.engine.spec(name)))
        if self.decode_engine is not None:
            self.decode_engine.start()
            for name in self.decode_engine.models():
                self.rpc.set_var(codec.SPEC_KEY + name,
                                 codec.pack(self.decode_engine.spec(name)))
            if self.role == "prefill":
                self._xfer = KVBlockSender()
                self.decode_engine.on_block_sealed = self._on_block_sealed
                self.decode_engine.on_handoff = self._on_handoff
            if self.role == "decode":
                self._adopt = AdoptTracker(self._on_orphan)
            if flags.flag("session_migration"):
                self._resume_buf = ResumeBuffer()
                self.migrator = SessionMigrator(
                    self.decode_engine, peers_fn=self._migration_peers,
                    occupancy_fn=self._peer_occupancy)
                if flags.flag("migrate_on_pressure"):
                    self.decode_engine.on_preempt = self._on_preempt
        self.rpc.serve(True)
        if _tm.enabled():
            self._pub_stop = _tm.start_publisher(
                self.rpc, interval_s=1.0, on_publish=self._pre_publish)
        self._thread = threading.Thread(target=self._poll_loop,
                                        name="serving-rpc", daemon=True)
        self._thread.start()
        return self

    def _pre_publish(self):
        """Gauges derived on every 1 s republish, from the series ring:
        each tier's windowed shed rate and each prefix-cache namespace's
        windowed hit rate."""
        window = float(flags.flag("serving_rate_window"))
        for flat, labels in _tm.label_sets("serving_tier_shed_total"):
            _tm.set_gauge("serving_tier_shed_rate",
                          _tm.series_rate(flat, window),
                          tier=labels.get("tier", "default"))
        for flat, labels in _tm.label_sets(
                "prefix_cache_ns_lookup_tokens_total"):
            ns = labels.get("namespace", "default")
            lookups = _tm.series_rate(flat, window)
            hits = _tm.series_rate(
                "prefix_cache_ns_hit_tokens_total{namespace=%s}" % ns,
                window)
            _tm.set_gauge("prefix_cache_ns_hit_rate",
                          hits / lookups if lookups > 0 else 0.0,
                          namespace=ns)

    def attach_fleet(self, fleet):
        """Wire a ``ServingFleet``: its heartbeats arrive on this
        server's event stream, and both engines' batch boundaries tick
        it, so a membership change publishes between batches."""
        self.fleet = fleet
        self.engine.on_batch_boundary = fleet.tick
        if self.decode_engine is not None:
            self.decode_engine.on_batch_boundary = fleet.tick

    def _poll_loop(self):
        while True:
            try:
                t, name, arr = self.rpc.poll()
            except ConnectionError:
                return             # transport torn down under the loop
            if t == 0 or self._stopped.is_set():
                return             # shut down; a late frame is dropped
            if t != EV_SEND or name is None:
                continue
            try:
                self._route(name, arr)
                if self.fleet is not None:
                    self.fleet.tick()
            except Exception:  # one bad frame never stops the replica
                _log.exception("serving frame %r failed", name)

    def _route(self, name, arr):
        if name.startswith(codec.INFER_KEY):
            self._on_infer(name[len(codec.INFER_KEY):], arr)
        elif name.startswith(codec.GEN_KEY):
            self._on_generate(name[len(codec.GEN_KEY):], arr)
        elif name.startswith(codec.ABORT_KEY):
            rid = name[len(codec.ABORT_KEY):]
            if self.decode_engine is not None:
                self.decode_engine.abort(rid)
            self._reconcile_abort(rid)
        elif name.startswith(codec.KVXFER_KEY):
            self._on_kvxfer(name[len(codec.KVXFER_KEY):], arr)
        elif name.startswith(codec.RESUME_KEY):
            self._on_resume(name[len(codec.RESUME_KEY):], arr)
        elif name == codec.ROLLOUT_SET_KEY:
            try:
                doc, _ = codec.unpack(arr)
            except (ValueError, KeyError, UnicodeDecodeError):
                return
            self.apply_rollout(doc)
        elif name.startswith(codec.ROLLOUT_CTL_KEY):
            self._on_rollout_ctl(name[len(codec.ROLLOUT_CTL_KEY):], arr)
        elif name == codec.RETIRE_KEY:
            self._on_retire()
        elif self.fleet is not None:
            self.fleet.on_event(name, arr)

    def _injected(self, point, req_id):
        """Check an arrival fault point -> True when it took the request:
        "drop" loses the frame, "error" answers it with an error reply."""
        fault = maybe_fail(point)
        if fault == "error":
            self._publish(req_id, InferReply(
                "error", error="injected fault: " + point))
        return fault in ("drop", "error")

    def _on_infer(self, req_id, arr):
        if self._injected("serving.infer", req_id):
            return
        try:
            meta, arrays = codec.unpack(arr)
            feeds = dict(zip(meta["feeds"], arrays))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            self._publish(req_id, None)
            return
        tp = meta.get(codec.TRACEPARENT)
        with _tr.remote_parent(tp):
            with _tr.span("serving.admission", req_id=req_id,
                          model=meta.get("model", ""), rank=self.rank):
                self.engine.submit(
                    meta.get("model", ""), feeds,
                    tenant=meta.get("tenant", "default"),
                    deadline_ms=meta.get("deadline_ms"), req_id=req_id,
                    tier=meta.get(codec.TIER), traceparent=tp,
                    callback=self._publish_pending)

    def _on_generate(self, req_id, arr):
        if self._injected("serving.generate", req_id):
            return
        try:
            meta, arrays = codec.unpack(arr)
            prompt = arrays[0]
        except (ValueError, KeyError, IndexError, UnicodeDecodeError):
            self._publish(req_id, None)
            return
        if self.decode_engine is None:
            self._publish(req_id, InferReply(
                "error", error="replica has no decode engine"))
            return
        if self.role == "prefill" and self._try_handoff(req_id, meta,
                                                        prompt):
            return
        on_token = self._stream_publisher() if meta.get("stream") else None
        tp = meta.get(codec.TRACEPARENT)
        with _tr.remote_parent(tp):
            with _tr.span("serving.admission", req_id=req_id, decode=True,
                          model=meta.get("model", ""), rank=self.rank):
                self.decode_engine.submit(
                    meta.get("model", ""), prompt,
                    max_new_tokens=int(meta.get("max_new_tokens", 16)),
                    deadline_ms=meta.get("deadline_ms"),
                    eos_id=int(meta.get("eos_id", -1)), req_id=req_id,
                    on_token=on_token, tenant=meta.get("tenant", "default"),
                    tier=meta.get(codec.TIER), traceparent=tp,
                    callback=self._publish_pending)

    # -- disaggregated prefill and decode ------------------------------------

    def _advertised_ep(self):
        """This replica's endpoint as peers reach it."""
        if self.fleet is not None and self.rank < len(self.fleet.endpoints):
            return self.fleet.endpoints[self.rank]
        return "127.0.0.1:%d" % self.port

    def _pick_decode_peer(self):
        """Round robin over the live decode endpoints (the fleet's view
        when attached, else the static ``decode_peers``)."""
        peers = []
        if self.fleet is not None:
            peers = self.fleet.live_role_endpoints("decode")
        if not peers:
            peers = list(self._decode_peers_static)
        if not peers:
            return None
        self._pair_rr += 1
        return peers[self._pair_rr % len(peers)]

    def _migration_peers(self):
        """Endpoints a session may move to: every live replica running a
        decode engine (decode and serve roles) but this one, else the
        static ``decode_peers``."""
        me = self._advertised_ep()
        peers = []
        if self.fleet is not None:
            for role in ("decode", "serve"):
                peers.extend(self.fleet.live_role_endpoints(role))
        if not peers:
            peers = list(self._decode_peers_static)
        return [p for p in dict.fromkeys(peers) if p != me]

    def _peer_occupancy(self):
        """endpoint -> windowed KV occupancy from the monitor's last
        fleet document (empty without one)."""
        doc = getattr(self.fleetmon, "last", None)
        if not doc:
            return {}
        return {r["endpoint"]: float(r.get("kv_occupancy", 0.0))
                for r in doc.get("replicas", []) if r.get("up")}

    def _wire_dtype(self, model):
        m = self.decode_engine._models.get(model)
        return m.kv_config.dtype if m is not None else "f32"

    def _try_handoff(self, req_id, meta, prompt):
        """Prefill-role admission: pick a decode peer, announce the pair,
        then run the handoff prefill, or forward the commit at once when
        no full block transfers.  False: serve the request here (no live
        peer, or it did not answer the expect frame); the published pair
        ``{"decode": None}`` tells the client so."""
        model = meta.get("model", "")
        peer = self._pick_decode_peer()
        if peer is not None and self._xfer is not None:
            self._xfer.register(req_id, peer, model, self._wire_dtype(model))
            # the expect frame goes out before the pair is visible: once a
            # client can learn the pair, the decode half knows the request
            if not self._xfer.send_expect_now(req_id, {
                    "model": model, "prefill_ep": self._advertised_ep(),
                    "deadline_ms": meta.get("deadline_ms")}):
                self._xfer.forget(req_id)
                peer = None
        else:
            peer = None
        self._publish_keyed(codec.PAIR_KEY + req_id,
                            codec.pack({"decode": peer}))
        if peer is None:
            _tm.inc("serving_handoff_fallback_total")
            return False
        prompt_list = [int(t) for t in np.asarray(prompt).reshape(-1)]
        entry = {"decode": peer, "meta": dict(meta), "prompt": prompt_list,
                 "t_arrive": time.perf_counter()}
        with self._pair_lock:
            self._pairs[req_id] = entry
            while len(self._pairs) > _REPLY_RING:
                self._pairs.pop(next(iter(self._pairs)))
        upto = self.decode_engine.handoff_prefill_upto(model,
                                                       len(prompt_list))
        if upto <= 0:
            # no full block below the tail: the decode half does it all
            self._xfer.enqueue_commit(req_id, self._commit_meta(
                entry, digests=[],
                phases={"prefill_queue_wait_ms": 0.0, "prefill_ms": 0.0}))
            return True
        tp = meta.get(codec.TRACEPARENT)
        with _tr.remote_parent(tp):
            with _tr.span("serving.admission", req_id=req_id, decode=True,
                          handoff=True, model=model, rank=self.rank):
                self.decode_engine.submit(
                    model, prompt_list,
                    max_new_tokens=int(meta.get("max_new_tokens", 16)),
                    deadline_ms=meta.get("deadline_ms"),
                    eos_id=int(meta.get("eos_id", -1)), req_id=req_id,
                    tenant=meta.get("tenant", "default"),
                    tier=meta.get(codec.TIER), traceparent=tp,
                    handoff=True, callback=self._handoff_done)
        return True

    def _commit_meta(self, entry, digests, phases):
        meta = entry["meta"]
        dl = meta.get("deadline_ms")
        remaining = None
        if dl:
            used = (time.perf_counter() - entry["t_arrive"]) * 1e3
            remaining = max(1.0, float(dl) - used)
        return {"model": meta.get("model", ""), "prompt": entry["prompt"],
                "max_new": int(meta.get("max_new_tokens", 16)),
                "eos_id": int(meta.get("eos_id", -1)),
                "stream": bool(meta.get("stream")),
                "tenant": meta.get("tenant", "default"),
                "tier": meta.get(codec.TIER),
                "deadline_ms": remaining,
                codec.TRACEPARENT: meta.get(codec.TRACEPARENT),
                "digests": list(digests), "phases": dict(phases),
                "sent_unix": time.time(),
                "prefill_ep": self._advertised_ep()}

    def _on_block_sealed(self, m, s, j, digest):
        """Engine hook (decode thread, between steps): copy the sealed
        block off the pools and queue its frame."""
        try:
            arrays = m.cache.export_block(s.blocks[j])
        except (RuntimeError, IndexError):
            _log.exception("exporting block %d of %s failed", j,
                           s.pending.req_id)
            _tm.inc("kv_xfer_send_errors_total")
            return
        self._xfer.enqueue_block(s.pending.req_id, j, digest, arrays)

    def _on_handoff(self, m, s):
        """Engine hook: the feed pointer reached the boundary; queue the
        commit with the prefill half's phases."""
        rid = s.pending.req_id
        with self._pair_lock:
            entry = self._pairs.get(rid)
        if entry is None:
            return
        now = time.perf_counter()
        t_admit = s.t_admit if s.t_admit is not None else now
        phases = {"prefill_queue_wait_ms": round(
            (t_admit - s.pending.t_submit) * 1e3, 3),
            "prefill_ms": round((now - t_admit) * 1e3, 3),
            "prefill_cached_tokens": s.cached_tokens}
        bs = m.kv_config.block_size
        digests = list(s.hashes[:s.prefill_upto // bs]) if s.hashes else []
        self._xfer.enqueue_commit(rid, self._commit_meta(entry, digests,
                                                         phases))

    def _handoff_done(self, pending):
        """The prefill side's completion: "handoff" means the commit went
        out; any other end relays a cancel, so the decode half frees its
        adoptions and answers the client."""
        if pending.reply.status != "handoff":
            self._relay_cancel(pending.req_id, pending.reply.to_meta())

    def _relay_cancel(self, rid, reply_meta):
        with self._pair_lock:
            entry = self._pairs.pop(rid, None)
        if entry is not None and self._xfer is not None:
            self._xfer.enqueue_cancel(rid, reply_meta)

    def _reconcile_abort(self, rid):
        """A client's ``__abort__`` frees both halves: the prefill side
        relays a cancel, the decode side forgets uncommitted adoptions."""
        self._relay_cancel(rid, {"status": "aborted",
                                 "error": "aborted by client"})
        if self._adopt is not None:
            entry = self._adopt.cancel(rid)
            if entry is not None and entry["digests"] \
                    and self.decode_engine is not None:
                self.decode_engine.forget_adopted(entry["model"],
                                                  entry["digests"])

    def _tracker(self):
        if self._adopt is None:
            self._adopt = AdoptTracker(self._on_orphan)
        return self._adopt

    def _on_kvxfer(self, req_id, arr):
        if self.decode_engine is None:
            return
        try:
            meta, arrays = codec.unpack_kvxfer(arr)
        except ValueError as e:
            _tm.inc("kv_xfer_rejected_total", reason="frame")
            _tr.note("kvxfer_reject", req_id=req_id, error=str(e)[:200])
            return
        kind = meta.get("kind")
        if kind == "session":
            self._on_session(req_id, meta, arrays)
            return
        if kind == "block" and meta.get("session"):
            self._on_session_block(req_id, meta, arrays)
            return
        tracker = self._tracker()
        if kind == "expect":
            tracker.expect(req_id, meta)
        elif kind == "block":
            err = tracker.on_block(req_id, meta)
            if err is not None:
                _tm.inc("kv_xfer_rejected_total", reason="position")
                _tr.note("kvxfer_reject", req_id=req_id, error=err)
                return
            self.decode_engine.adopt_kv_block(meta.get("model", ""),
                                              meta["digest"], arrays)
        elif kind == "commit":
            self._on_commit(req_id, meta)
        elif kind == "cancel":
            entry = tracker.cancel(req_id)
            if entry is not None and entry["digests"]:
                self.decode_engine.forget_adopted(entry["model"],
                                                  entry["digests"])
            self._publish_cancel(req_id, meta.get("reply") or {})

    def _on_commit(self, req_id, meta):
        """Commit frame: submit through the ordinary path (admission
        prefix-matches the adopted blocks) and merge the prefill side's
        phases into the reply."""
        self._tracker().commit(req_id)
        model = meta.get("model", "")
        on_token = self._stream_publisher() if meta.get("stream") else None
        extra = dict(meta.get("phases") or {})
        sent = meta.get("sent_unix")
        if sent:
            extra["xfer_ms"] = round(
                max(0.0, (time.time() - float(sent)) * 1e3), 3)
        extra["role"] = "disagg"
        tp = meta.get(codec.TRACEPARENT)

        def cb(pending):
            pending.reply.phases.update(extra)
            self._publish_pending(pending)

        with _tr.remote_parent(tp):
            with _tr.span("serving.adopt_commit", req_id=req_id,
                          model=model, rank=self.rank):
                self.decode_engine.submit(
                    model, meta.get("prompt") or [],
                    max_new_tokens=int(meta.get("max_new", 16)),
                    deadline_ms=meta.get("deadline_ms"),
                    eos_id=int(meta.get("eos_id", -1)), req_id=req_id,
                    tenant=meta.get("tenant", "default"),
                    tier=meta.get("tier"), traceparent=tp,
                    on_token=on_token, callback=cb)

    def _on_orphan(self, rid, entry):
        """The janitor's verdict: the prefill half died before its
        commit.  Free the adopted blocks and publish a timeout, so the
        client's replay takes over."""
        if entry.get("digests") and self.decode_engine is not None:
            self.decode_engine.forget_adopted(entry.get("model") or "",
                                              entry["digests"])
        _tr.note("kvxfer_orphan", req_id=rid)
        self._stream_publisher()(rid, 0, None, True, "timeout")
        self._publish(rid, InferReply(
            "timeout", error="prefill half died before handoff commit"))

    def _publish_cancel(self, req_id, reply_meta):
        status = reply_meta.get("status") or "aborted"
        if status in ("ok", "handoff"):
            status = "error"
        rep = InferReply(status, error=reply_meta.get("error"),
                         retry_after_ms=reply_meta.get("retry_after_ms")
                         or 0.0)
        # unblock a parked streaming client, then publish the reply
        self._stream_publisher()(req_id, 0, None, True, rep.status)
        self._publish(req_id, rep)

    # -- live session migration ----------------------------------------------

    def _on_session_block(self, req_id, meta, arrays):
        """A migration's block frame: a sealed history block is adopted
        at once (warming the index whether or not the resume lands); the
        tail is held until its session frame."""
        if self._resume_buf is None:
            _tm.inc("kv_migrate_refused_total", reason="disabled")
            return
        if meta.get("tail"):
            self._resume_buf.put_tail(req_id, meta.get("digest"),
                                      meta.get("valid", 0), arrays)
            return
        res = self.decode_engine.adopt_kv_block(meta.get("model", ""),
                                                meta["digest"], arrays)
        if res == "adopted":
            # only this hand-off's blocks are forgotten on a refusal
            self._resume_buf.note_adopted(req_id, meta["digest"])

    def _publish_resume_ack(self, req_id, status, error=None):
        doc = {"status": status}
        if error:
            doc["error"] = error
        self._publish_keyed(codec.RESUME_ACK_KEY + req_id, codec.pack(doc))

    def _on_session(self, req_id, meta, arrays):
        """A migration's manifest (its last frame): take the buffered
        tail, resume through the ordinary submit and ack the verdict; the
        source finishes its copy only after "resumed"."""
        entry = (self._resume_buf.take(req_id)
                 if self._resume_buf is not None else None) or {}
        if self._resume_buf is None:
            _tm.inc("kv_migrate_refused_total", reason="disabled")
            self._publish_resume_ack(req_id, "refused",
                                     "session migration disabled here")
            return
        try:
            prompt = [int(t) for t in np.asarray(arrays[0]).reshape(-1)]
            resume_out = np.asarray(arrays[1]).reshape(-1)
        except (IndexError, ValueError, TypeError):
            _tm.inc("kv_migrate_refused_total", reason="bad_resume")
            self._publish_resume_ack(req_id, "refused",
                                     "malformed session manifest")
            return
        if int(meta.get("pos", -1)) != len(prompt) + len(resume_out) - 1:
            _tm.inc("kv_migrate_refused_total", reason="pos_mismatch")
            self._publish_resume_ack(
                req_id, "refused",
                "manifest pos %s disagrees with prompt+tokens %d"
                % (meta.get("pos"), len(prompt) + len(resume_out) - 1))
            return
        resume_tail = None
        if entry.get("tail") is not None:
            resume_tail = {"digest": entry.get("tail_digest"),
                           "valid": entry.get("tail_valid", 0),
                           "arrays": entry.get("tail")}
        self._resume_submit(req_id, meta, prompt, resume_out, resume_tail,
                            entry.get("digests") or [])

    def _on_resume(self, req_id, arr):
        """A client's crash resume: prompt + the tokens it holds.  Any
        replica resumes it; one whose history index is warm re-feeds less
        than a block."""
        try:
            meta, arrays = codec.unpack(arr)
            prompt = [int(t) for t in np.asarray(arrays[0]).reshape(-1)]
            resume_out = np.asarray(arrays[1]).reshape(-1)
        except (ValueError, KeyError, IndexError, TypeError,
                UnicodeDecodeError):
            self._publish_resume_ack(req_id, "refused",
                                     "malformed resume request")
            return
        if self.decode_engine is None:
            self._publish_resume_ack(req_id, "refused",
                                     "replica has no decode engine")
            return
        self._resume_submit(req_id, meta, prompt, resume_out, None, [])

    def _resume_submit(self, req_id, meta, prompt, resume_out, resume_tail,
                       adopted_digests):
        """Submit with ``resume_from`` and ack the verdict; a refusal at
        admission forgets the blocks this hand-off adopted, leaving the
        pool as it was."""
        model = meta.get("model", "")
        on_token = self._stream_publisher() if meta.get("stream") else None
        tp = meta.get(codec.TRACEPARENT)
        with _tr.remote_parent(tp):
            with _tr.span("serving.resume", req_id=req_id, model=model,
                          rank=self.rank):
                pending = self.decode_engine.submit(
                    model, prompt,
                    max_new_tokens=int(meta.get("max_new_tokens", 16)),
                    deadline_ms=meta.get("deadline_ms"),
                    eos_id=int(meta.get("eos_id", -1)), req_id=req_id,
                    tenant=meta.get("tenant", "default"),
                    tier=meta.get("tier"), traceparent=tp,
                    on_token=on_token, resume_from=resume_out,
                    resume_tail=resume_tail,
                    callback=self._publish_pending)
        rep = pending.reply
        if rep is not None and rep.status in ("error", "shed"):
            if adopted_digests:
                self.decode_engine.forget_adopted(model, adopted_digests)
            self._publish_resume_ack(req_id, "refused", rep.error)
            return False
        self._publish_resume_ack(req_id, "resumed")
        return True

    def _on_preempt(self, victims):
        """Engine hook (decode thread, lock released): push each preempted
        session to the least-loaded peer on a side thread, so the ack wait
        never blocks the loop; a refused or failed push leaves the victim
        queued for its local replay."""
        mig = self.migrator
        if mig is None or not victims:
            return

        def push():
            for rid, _model in victims:
                try:
                    mig.migrate(rid, trigger="pressure")
                except ValueError:
                    pass           # finished or replayed meanwhile

        threading.Thread(target=push, name="serving-migrate-pressure",
                         daemon=True).start()

    # -- publishing ----------------------------------------------------------

    def _publish_keyed(self, key, buf):
        """Publish ``buf`` under ``key`` and add the key to the ring."""
        self.rpc.set_var(key, buf)
        with self._reply_lock:
            self._reply_keys.append(key)
            while len(self._reply_keys) > _REPLY_RING:
                self.rpc.del_var(self._reply_keys.pop(0))

    def _stream_publisher(self):
        """``on_token`` for the decode engine: chunk k of a request is
        ``__stream__:<id>:<k>``; the last (or a terminal error) sets
        done."""

        def on_token(rid, index, token, done, status):
            chunk = {"i": int(index), "done": bool(done), "status": status,
                     "token": None if token is None else int(token)}
            if done and status == "migrated":
                # the engine published the reply first (its _finish)
                with self._reply_lock:
                    dest = self._migrated_to.pop(rid, None)
                if dest:
                    chunk["migrated_to"] = dest
            self._publish_keyed(
                "%s%s:%d" % (codec.STREAM_KEY, rid, index),
                codec.pack(chunk))
        return on_token

    def _publish_pending(self, pending):
        """An engine's completion callback: publish its reply."""
        self._publish(pending.req_id, pending.reply, pending)

    def _publish(self, req_id, reply, pending=None):
        fault = maybe_fail("serving.reply")
        if fault == "drop":
            return                     # the client's GET times out
        if reply is None:
            reply = InferReply("error", error="malformed request")
        if fault == "error":
            reply = InferReply("error", error="injected fault: serving.reply")
        # runs on the completing thread: parent under the request span
        with _tr.span("serving.reply_publish",
                      parent=getattr(pending, "span", None),
                      req_id=req_id, status=reply.status):
            meta = reply.to_meta()
            if reply.status == "migrated":
                with self._reply_lock:
                    self._migrated_to[req_id] = reply.phases.get(
                        "migrated_to")
                    while len(self._migrated_to) > _REPLY_RING:
                        self._migrated_to.popitem(last=False)
            tp = getattr(pending, "traceparent", None)
            if tp:
                meta[codec.TRACEPARENT] = tp
            names = list(reply.outputs)
            self._publish_keyed(codec.REPLY_KEY + req_id, codec.pack(
                meta, [reply.outputs[n] for n in names]))

    # -- control plane -------------------------------------------------------

    def apply_rollout(self, doc):
        """Adopt a route table ({"models": {base: {active, canary,
        fraction, state}}}) through ``ServingEngine.apply_routes``,
        skipping versions this replica lacks, and republish
        ``__rollout__``."""
        self.engine.apply_routes(doc.get("models") or {})
        self.rpc.set_var(codec.ROLLOUT_KEY,
                         codec.pack({"models": self.engine.routes()}))

    def _on_rollout_ctl(self, req_id, arr):
        """One admin command for the controller; its reply meta's keys
        other than status and error ride in the reply's phases."""
        try:
            cmd, _ = codec.unpack(arr)
        except (ValueError, KeyError, UnicodeDecodeError):
            self._publish(req_id, None)
            return
        if self.rollout is None:
            reply = InferReply("error",
                               error="replica has no rollout controller")
        else:
            meta = self.rollout.handle(cmd)
            reply = InferReply(meta.get("status", "error"),
                               error=meta.get("error"),
                               phases={k: v for k, v in meta.items()
                                       if k not in ("status", "error")})
        self._publish(req_id, reply)

    def _on_retire(self):
        """Drain both engines on a side thread (the poll loop keeps
        serving what is queued), then call ``on_retire``."""
        if self._retire_thread is not None:
            return

        def drain():
            self.engine.drain()
            if self.decode_engine is not None:
                mig = None
                if self.migrator is not None \
                        and flags.flag("migrate_on_drain"):
                    mig = self.migrator.drain_push(trigger="drain")
                self.decode_engine.drain(migrate=mig)
            if self.on_retire is not None:
                self.on_retire()

        self._retire_thread = threading.Thread(
            target=drain, name="serving-retire", daemon=True)
        self._retire_thread.start()

    def set_alive(self, epoch, is_coordinator):
        self.rpc.set_var(codec.ALIVE_KEY, np.asarray(
            [self.rank, int(epoch), 1 if is_coordinator else 0], np.int64))

    def shutdown(self):
        """Stop the metrics publisher, the rollout controller and the
        fleet (a publisher left running would republish into the next
        server of the process), then both engines (their queued requests
        get error replies), then the transport, and join the poll thread.
        Idempotent."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._pub_stop is not None:
            self._pub_stop.stop()
        if self.rollout is not None:
            self.rollout.stop()
        if self.fleetmon is not None:
            self.fleetmon.stop()
        if self.fleet is not None:
            self.fleet.stop()
        self.engine.stop()
        if self.decode_engine is not None:
            self.decode_engine.stop()
        if self._xfer is not None:
            self._xfer.close()
        if self._adopt is not None:
            self._adopt.close()
        if self.migrator is not None:
            self.migrator.close()
        self.rpc.shutdown()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
