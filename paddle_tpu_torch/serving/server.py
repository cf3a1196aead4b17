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
                            final reply lands on ``__reply__:<id>``
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
  ``__retire__``            drain both engines, then call ``on_retire``

Replies and stream chunks join a FIFO ring of ``_REPLY_RING`` keys, the
oldest deleted past it, so clients that never read cannot grow the store.
With a fleet attached (``attach_fleet``), the fleet ticks after every
inbound frame and at both engines' batch boundaries.

Features of the reference the port lacks answer so that no client waits
on them: ``__rollout_ctl__:<id>`` on a server without a controller gets
the reference's "replica has no rollout controller" error reply, and
``__resume__:<id>`` a refused ``__resumeack__:<id>``.  Left out, compared
with the reference: the prefill and decode roles (``serving/disagg.py``:
``role`` other than "serve" raises) and their ``__kvxfer__`` /
``__pair__`` frames, session migration, tracing spans and the
``serving.*`` fault points.
"""

import logging
import threading

import numpy as np

from .. import flags
from ..core import telemetry as _tm
from ..native.rpc import EV_SEND, RpcServer
from . import codec
from .engine import InferReply

__all__ = ["ServingServer"]

_REPLY_RING = 1024

_log = logging.getLogger(__name__)


class ServingServer:
    """``engine`` (a ``ServingEngine``) and optionally ``decode_engine`` (a
    ``DecodeEngine``) behind one RPC endpoint on ``port`` (0: any free
    one, then ``self.port``)."""

    def __init__(self, engine, port=0, rank=0, decode_engine=None,
                 role=None):
        if (role or "serve") != "serve":
            raise ValueError(
                "serving role %r: the prefill and decode roles "
                "(serving/disagg.py) are not ported; the port serves the "
                "monolith role \"serve\" only" % (role,))
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
        self._thread = None
        self._stopped = threading.Event()

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
            if self.decode_engine is not None:
                self.decode_engine.abort(name[len(codec.ABORT_KEY):])
        elif name.startswith(codec.RESUME_KEY):
            self._publish_keyed(
                codec.RESUME_ACK_KEY + name[len(codec.RESUME_KEY):],
                codec.pack({"status": "refused",
                            "error": "session migration (serving/"
                                     "migrate.py) is not ported"}))
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

    def _on_infer(self, req_id, arr):
        try:
            meta, arrays = codec.unpack(arr)
            feeds = dict(zip(meta["feeds"], arrays))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            self._publish(req_id, None)
            return
        self.engine.submit(
            meta.get("model", ""), feeds,
            tenant=meta.get("tenant", "default"),
            deadline_ms=meta.get("deadline_ms"), req_id=req_id,
            tier=meta.get(codec.TIER),
            callback=lambda pending: self._publish(pending.req_id,
                                                   pending.reply))

    def _on_generate(self, req_id, arr):
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
        on_token = self._stream_publisher() if meta.get("stream") else None
        self.decode_engine.submit(
            meta.get("model", ""), prompt,
            max_new_tokens=int(meta.get("max_new_tokens", 16)),
            deadline_ms=meta.get("deadline_ms"),
            eos_id=int(meta.get("eos_id", -1)), req_id=req_id,
            on_token=on_token, tenant=meta.get("tenant", "default"),
            callback=lambda pending: self._publish(pending.req_id,
                                                   pending.reply))

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
            self._publish_keyed(
                "%s%s:%d" % (codec.STREAM_KEY, rid, index),
                codec.pack({"i": int(index), "done": bool(done),
                            "status": status,
                            "token": None if token is None
                            else int(token)}))
        return on_token

    def _publish(self, req_id, reply):
        if reply is None:
            reply = InferReply("error", error="malformed request")
        names = list(reply.outputs)
        self._publish_keyed(codec.REPLY_KEY + req_id, codec.pack(
            reply.to_meta(), [reply.outputs[n] for n in names]))

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
                self.decode_engine.drain()
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
        self.rpc.shutdown()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
