"""Serving client of the port: request and reply over the tensor RPC wire,
with failover across replicas.

Counterpart of ``paddle_tpu/serving/client.py`` (``ServingClient``) for
monolith replicas.  One ``infer`` is a send (``__infer__:<req_id>``) and a
deadline-bounded GET of ``__reply__:<req_id>``, which the server parks
until the reply exists.  On a dead or hung replica the request is replayed
on the next endpoint; the endpoints file (``FLAGS_serving_endpoints_file``)
is re-read on every failure.  A "timeout" reply (the request expired in a
replica's queue) is replayed too, and a "shed" reply up to
``FLAGS_serving_client_shed_retries`` times after its ``retry_after_ms``
(exponential, jittered).  ``generate`` first sends ``__abort__:<req_id>``
to a replica it abandons, so a half-prefilled sequence frees its KV
blocks there, and replays under a fresh request id; streamed tokens are
delivered by index, each once, however many attempts a request takes
(greedy decode is deterministic, so a replayed prefix is the same).
``scrape`` reads a replica's ``__metrics__`` snapshot; ``rollout`` sends
an admin command to the fleet's coordinator and ``rollout_state`` reads a
replica's applied routes.

With ``FLAGS_tracing`` on, each ``infer`` and ``generate`` opens a root
span (``client.infer``, ``client.generate``) whose ``traceparent`` rides
the request meta; the root is active around the sends and GETs, so the
RPC frames carry its context too, and it ends with the request's status,
endpoint and attempts.

A disaggregated fleet publishes a ``roles`` column beside its endpoints
(``serving/fleet.py``; or ``roles=`` parallel to static endpoints):
``generate`` then sends ``__generate__`` to a prefill-role replica,
reads its ``__pair__:<req_id>`` hint and walks the ``__stream__`` and
``__reply__`` vars on the named decode replica (on the same connection
when the hint is None).  On failover it aborts both halves, the decode
half first, so a dead pair strands no adopted blocks.

Session migration (``serving/migrate.py``), as in the reference:

- **follow**: a replica that migrated a session away ends its stream with
  status "migrated" and a reply whose phases name ``migrated_to``; the
  client moves there and keeps walking the same stream indices.  The
  port's server also names the destination in that last chunk, and the
  client then follows without reading the reply: a replica retired by a
  drain exits once its sessions have moved, and a read after the chunk
  could find it gone;
- **resume**: on a ConnectionError mid-stream, with tokens in hand and
  ``FLAGS_session_migration`` on, the next attempt sends
  ``__resume__:<req_id>`` (the prompt and the tokens received) under the
  same id, and reads the stream from index ``len(received)``; a refused
  resume falls back to a full replay under a fresh id.

``client_resume_total{result}``, ``client_migrate_follow_total`` and
``client_stream_dup_total`` count them.
"""

import json
import random
import time
import uuid

import numpy as np

from .. import flags
from ..core import telemetry as _tm
from ..core import tracing as _tr
from ..native import rpc as _rpc
from ..native.rpc import RpcClient
from . import codec
from .engine import InferReply

__all__ = ["ServingClient", "read_endpoints_file", "read_endpoints_doc"]


def read_endpoints_file(path):
    """{"epoch": N, "endpoints": [...]}, as a fleet coordinator writes it
    (by atomic rename) -> the endpoints."""
    with open(path) as f:
        doc = json.load(f)
    return [str(e) for e in doc.get("endpoints", [])]


def read_endpoints_doc(path):
    """(endpoints, the parallel roles column or None); a roles list that
    does not parallel the endpoints is dropped."""
    with open(path) as f:
        doc = json.load(f)
    eps = [str(e) for e in doc.get("endpoints", [])]
    roles = doc.get("roles")
    if roles and len(roles) == len(eps):
        return eps, [str(r) for r in roles]
    return eps, None


def _reply_of(meta, arrays, t0):
    """An InferReply from a packed reply, with the client's latency and
    its ``wire_ms`` (the client's latency less the server's)."""
    reply = InferReply(
        meta.get("status", "error"),
        outputs=dict(zip(meta.get("outputs", []), arrays)),
        error=meta.get("error"),
        retry_after_ms=meta.get("retry_after_ms", 0.0),
        phases=dict(meta.get("phases") or {}))
    reply.latency_ms = (time.perf_counter() - t0) * 1e3
    srv_ms = float(meta.get("latency_ms") or 0.0)
    if srv_ms > 0.0:
        reply.phases["wire_ms"] = round(max(reply.latency_ms - srv_ms, 0.0),
                                        3)
    return reply


class ServingClient:
    def __init__(self, endpoints=None, endpoints_file=None,
                 tenant="default", deadline_ms=None, roles=None):
        self.endpoints_file = endpoints_file or \
            flags.flag("serving_endpoints_file") or None
        self._static = list(endpoints or [])
        # a static role column parallel to ``endpoints``; an endpoints
        # file's own column wins
        self._roles = list(roles) if roles else None
        if self._roles and len(self._roles) != len(self._static):
            raise ValueError("client roles must parallel endpoints")
        self.tenant = tenant
        self.default_deadline_ms = float(
            deadline_ms if deadline_ms is not None
            else flags.flag("serving_deadline_ms"))
        self._rr = 0
        self.failovers = 0
        self.shed_retries = 0
        if not self._static and not self.endpoints_file:
            raise ValueError("ServingClient needs endpoints or an "
                             "endpoints file")

    def endpoints(self):
        """The endpoints file's list when it has one, else the static
        list."""
        if self.endpoints_file:
            try:
                eps = read_endpoints_file(self.endpoints_file)
                if eps:
                    return eps
            except (OSError, ValueError):
                pass
        return list(self._static)

    def endpoints_with_roles(self):
        """[(endpoint, role)]; the role is "serve" where no column is
        published."""
        if self.endpoints_file:
            try:
                eps, roles = read_endpoints_doc(self.endpoints_file)
                if eps:
                    return list(zip(eps, roles or ["serve"] * len(eps)))
            except (OSError, ValueError):
                pass
        return list(zip(self._static,
                        self._roles or ["serve"] * len(self._static)))

    # -- one-shot GETs -------------------------------------------------------

    def _get_packed(self, endpoint, key, timeout):
        c = RpcClient(endpoint, connect_timeout=min(timeout, 5.0),
                      rpc_deadline=timeout, retry_times=0)
        try:
            return codec.unpack(c.get_var(key))
        finally:
            c.close()

    def spec(self, model, timeout=10.0):
        """The signature the servers publish for ``model`` (the first
        endpoint that answers)."""
        for ep in self.endpoints():
            try:
                meta, _ = self._get_packed(ep, codec.SPEC_KEY + model,
                                           timeout)
                return meta
            except ConnectionError:
                continue
        raise ConnectionError("no live endpoint answered __spec__:%s"
                              % model)

    def alive(self, endpoint, timeout=3.0):
        """[rank, epoch, is_coordinator], or None (``rpc.probe``)."""
        got = _rpc.probe(endpoint, key=codec.ALIVE_KEY, timeout=timeout)
        return None if got is None else [int(x) for x in got]

    def scrape(self, endpoint=None, timeout=10.0):
        """One replica's live ``__metrics__`` snapshot (default: the
        first endpoint)."""
        return _tm.scrape(endpoint or self.endpoints()[0], timeout=timeout)

    # -- rollout admin -------------------------------------------------------

    def rollout(self, cmd, timeout=10.0):
        """One RolloutController command ({"op": start|flip|abort|status,
        ...}) to the coordinator, tried first; -> the reply meta.  A
        replica that answers "not coordinator" is skipped."""
        last_err = None
        eps = sorted(self.endpoints(), key=lambda ep: 0 if (
            (self.alive(ep) or [0, 0, 0])[2]) else 1)
        for ep in eps:
            req_id = uuid.uuid4().hex
            try:
                c = RpcClient(ep, connect_timeout=2.0, rpc_deadline=timeout,
                              retry_times=0)
                try:
                    c.send_var(codec.ROLLOUT_CTL_KEY + req_id,
                               codec.pack(cmd))
                    meta, _ = codec.unpack(
                        c.get_var(codec.REPLY_KEY + req_id))
                finally:
                    c.close()
            except ConnectionError as e:
                last_err = str(e)
                continue
            if meta.get("status") == "error" and "coordinator" in (
                    meta.get("error") or ""):
                last_err = meta["error"]
                continue
            return meta
        raise ConnectionError("rollout command failed everywhere: %s"
                              % last_err)

    def rollout_state(self, endpoint, timeout=10.0):
        """One replica's applied routes (its ``__rollout__`` var):
        {"models": {base: {active, canary, fraction, state}}}."""
        meta, _ = self._get_packed(endpoint, codec.ROLLOUT_KEY, timeout)
        return meta

    # -- inference -----------------------------------------------------------

    def _shed_backoff(self, reply, sheds):
        """Wait out a shed reply's retry_after_ms, doubled per repeat,
        +-50% jitter."""
        base_s = min(max(reply.retry_after_ms, 1.0), 1000.0) / 1e3
        delay = min(base_s * (2.0 ** sheds), 2.0)
        time.sleep(delay * (0.5 + random.random()))
        self.shed_retries += 1

    def _attempts(self, n_eps, max_attempts):
        shed_cap = int(flags.flag("serving_client_shed_retries") or 0)
        return shed_cap, int(max_attempts or max(2 * n_eps, 2) + shed_cap)

    def infer(self, model, feeds, deadline_ms=None, max_attempts=None,
              tier=None, req_id=None):
        """One request, failing over across endpoints -> an InferReply
        whose status is ok|shed|timeout|error, or "dropped" when every
        attempt failed.  ``req_id`` (default a fresh uuid) names the
        request; a canary route splits by its hash, so a replay lands on
        the same version (a shed's retry takes a fresh id)."""
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        req_id = req_id or uuid.uuid4().hex
        # the root of the request's trace; the server's admission span
        # parents under the context the meta carries
        root = _tr.start_span("client.infer", model=model,
                              tenant=self.tenant, req_id=req_id)
        names = list(feeds)
        meta_req = {"model": model, "tenant": self.tenant,
                    "req_id": req_id, "deadline_ms": deadline_ms,
                    "feeds": names}
        if tier:
            meta_req[codec.TIER] = tier
        if root.traceparent:
            meta_req[codec.TRACEPARENT] = root.traceparent
        payload = codec.pack(meta_req, [feeds[n] for n in names])
        # the request may wait a whole deadline in the queue and still be
        # served: the GET waits that long and some
        get_timeout = deadline_ms / 1e3 + 30.0
        t0 = time.perf_counter()
        last_err, last_reply, sheds = None, None, 0
        eps = self.endpoints()
        shed_cap, attempts = self._attempts(len(eps), max_attempts)
        for i in range(attempts):
            if i:
                self.failovers += 1
                time.sleep(min(0.05 * i, 0.5))
                eps = self.endpoints()
            if not eps:
                last_err = "endpoints file empty"
                continue
            ep = eps[self._rr % len(eps)]
            self._rr += 1
            try:
                c = RpcClient(ep, connect_timeout=2.0,
                              rpc_deadline=get_timeout, retry_times=0)
                try:
                    with _tr.activate(root):
                        c.send_var(codec.INFER_KEY + req_id, payload)
                        meta, arrays = codec.unpack(
                            c.get_var(codec.REPLY_KEY + req_id))
                finally:
                    c.close()
            except ConnectionError as e:
                last_err = str(e)
                continue
            reply = _reply_of(meta, arrays, t0)
            if reply.status == "timeout" and i + 1 < attempts:
                # an overloaded replica, not a verdict: replay elsewhere
                last_err = "server timeout: %s" % reply.error
                last_reply = reply
                continue
            if reply.status == "shed" and sheds < shed_cap \
                    and i + 1 < attempts:
                last_err = "shed: %s" % reply.error
                last_reply = reply
                self._shed_backoff(reply, sheds)
                sheds += 1
                # the shed reply stays published under the old id
                req_id = uuid.uuid4().hex
                meta_req["req_id"] = req_id
                payload = codec.pack(meta_req, [feeds[n] for n in names])
                continue
            root.annotate(status=reply.status, endpoint=ep,
                          attempts=i + 1).end()
            return reply
        if last_reply is not None:
            root.annotate(status=last_reply.status, attempts=attempts).end()
            return last_reply
        root.annotate(status="dropped", attempts=attempts).end()
        return InferReply(
            "dropped", error="all %d attempts failed: %s"
            % (attempts, last_err),
            latency_ms=(time.perf_counter() - t0) * 1e3)

    # -- autoregressive decode -----------------------------------------------

    def _abort(self, endpoint, req_id):
        """Best-effort notice to a replica being abandoned: it frees the
        sequence's KV blocks."""
        try:
            c = RpcClient(endpoint, connect_timeout=1.0, rpc_deadline=3.0,
                          retry_times=0)
        except ConnectionError:
            return
        try:
            c.send_var(codec.ABORT_KEY + req_id,
                       codec.pack({"req_id": req_id}))
        except ConnectionError:
            pass
        finally:
            c.close()

    def _abort_pair(self, endpoint, decode_ep, req_id):
        """Abandon a disaggregated attempt: the decode half holds the
        adopted blocks, so it is aborted first; the prefill half relays a
        cancel too."""
        if decode_ep and decode_ep != endpoint:
            self._abort(decode_ep, req_id)
        self._abort(endpoint, req_id)

    def _gen_candidates(self):
        """(endpoint, role) pairs ``generate`` may send to: the prefill
        replicas when a role column names any, else every non-decode
        endpoint, decode replicas as the last resort."""
        cand = self.endpoints_with_roles()
        pf = [(e, r) for e, r in cand if r == "prefill"]
        if pf:
            return pf
        return [(e, r) for e, r in cand if r != "decode"] or cand

    def _connect(self, endpoint, timeout):
        return RpcClient(endpoint, connect_timeout=2.0, rpc_deadline=timeout,
                         retry_times=0)

    def generate(self, model, prompt_ids, max_new_tokens=16,
                 deadline_ms=None, eos_id=-1, stream=True, on_token=None,
                 max_attempts=None, tier=None):
        """One autoregressive request -> an InferReply whose
        outputs["tokens"] holds the generated ids.  With ``stream`` the
        client walks the ``__stream__`` chunks: ``on_token(i, token)``
        fires once per index, and the reply's phases gain the client's
        ``client_ttft_ms`` and ``client_itl_ms_samples`` (what a user
        sees, the wire included).  Fails over on ConnectionError (a
        resume when it holds tokens) and on timeout replies, aborting the
        abandoned attempt first; follows a migrated session."""
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        req_id = uuid.uuid4().hex
        root = _tr.start_span("client.generate", model=model,
                              tenant=self.tenant, req_id=req_id)
        prompt = np.ascontiguousarray(
            np.asarray(prompt_ids, np.int32).reshape(-1))
        meta_req = {"model": model, "tenant": self.tenant,
                    "req_id": req_id, "deadline_ms": deadline_ms,
                    "max_new_tokens": int(max_new_tokens),
                    "eos_id": int(eos_id), "stream": bool(stream)}
        if tier:
            meta_req[codec.TIER] = tier
        if root.traceparent:
            meta_req[codec.TRACEPARENT] = root.traceparent
        get_timeout = deadline_ms / 1e3 + 30.0
        t0 = time.perf_counter()
        last_err, last_reply, sheds = None, None, 0
        received = []          # tokens delivered to the caller, by index
        resume_allowed = bool(flags.flag("session_migration"))
        cand = self._gen_candidates()
        shed_cap, attempts = self._attempts(len(cand), max_attempts)

        def fresh_id():
            meta_req["req_id"] = uuid.uuid4().hex
            return meta_req["req_id"]

        for i in range(attempts):
            if i:
                self.failovers += 1
                time.sleep(min(0.05 * i, 0.5))
                cand = self._gen_candidates()
            if not cand:
                last_err = "endpoints file empty"
                continue
            ep, ep_role = cand[self._rr % len(cand)]
            self._rr += 1
            resuming = bool(stream and received and resume_allowed and i)
            chunk_times = []
            decode_ep = None
            conns = []
            try:
                c = self._connect(ep, get_timeout)
                conns.append(c)
                try:
                    with _tr.activate(root):
                        reader = c
                        if resuming:
                            # the same id, the prompt and the tokens held;
                            # the replica emits from len(received) on
                            c.send_var(codec.RESUME_KEY + req_id,
                                       codec.pack(meta_req, [
                                           prompt, np.asarray(
                                               received, np.int32)]))
                            am, _ = codec.unpack(c.get_var(
                                codec.RESUME_ACK_KEY + req_id))
                            if am.get("status") != "resumed":
                                _tm.inc("client_resume_total",
                                        result="refused")
                                last_err = "resume refused: %s" \
                                    % am.get("error")
                                # a full replay under a fresh id, for good
                                resume_allowed = False
                                req_id = fresh_id()
                                continue
                            _tm.inc("client_resume_total", result="resumed")
                        else:
                            c.send_var(codec.GEN_KEY + req_id,
                                       codec.pack(meta_req, [prompt]))
                            if ep_role == "prefill":
                                # the stream and reply come from the decode
                                # half, or from here when the hint is None
                                pm, _ = codec.unpack(c.get_var(
                                    codec.PAIR_KEY + req_id))
                                decode_ep = pm.get("decode")
                                if decode_ep:
                                    reader = self._connect(decode_ep,
                                                           get_timeout)
                                    conns.append(reader)
                        k = len(received) if resuming else 0
                        while stream:
                            cm, _ = codec.unpack(reader.get_var(
                                "%s%s:%d" % (codec.STREAM_KEY, req_id, k)))
                            if cm.get("token") is not None:
                                chunk_times.append(time.perf_counter())
                                idx = int(cm["i"])
                                if idx == len(received):
                                    received.append(int(cm["token"]))
                                    if on_token is not None:
                                        on_token(idx, int(cm["token"]))
                                else:
                                    # a replayed prefix: delivered already
                                    _tm.inc("client_stream_dup_total")
                            if cm.get("done"):
                                if cm.get("status") != "migrated":
                                    break
                                # follow the session to the replica that
                                # goes on at this same index: the chunk
                                # names it, else the reply does
                                dest = cm.get("migrated_to")
                                if not dest:
                                    mm, _ = codec.unpack(reader.get_var(
                                        codec.REPLY_KEY + req_id))
                                    dest = (mm.get("phases") or {}
                                            ).get("migrated_to")
                                if not dest:
                                    break
                                reader = self._connect(dest, get_timeout)
                                conns.append(reader)
                                _tm.inc("client_migrate_follow_total")
                                continue
                            k += 1
                        meta, arrays = codec.unpack(
                            reader.get_var(codec.REPLY_KEY + req_id))
                        while meta.get("status") == "migrated":
                            # unstreamed: the destination has the reply
                            dest = (meta.get("phases") or {}
                                    ).get("migrated_to")
                            if not dest:
                                break
                            reader = self._connect(dest, get_timeout)
                            conns.append(reader)
                            _tm.inc("client_migrate_follow_total")
                            meta, arrays = codec.unpack(
                                reader.get_var(codec.REPLY_KEY + req_id))
                finally:
                    for conn in conns:
                        conn.close()
            except ConnectionError as e:
                # free the abandoned attempt on both halves; with tokens in
                # hand the next attempt resumes under the same id, else it
                # replays under a fresh one (the abort publishes a terminal
                # reply under the old id)
                last_err = str(e)
                self._abort_pair(ep, decode_ep, req_id)
                if not (stream and received and resume_allowed):
                    req_id = fresh_id()
                continue
            reply = _reply_of(meta, arrays, t0)
            if chunk_times:
                reply.phases["client_ttft_ms"] = round(
                    (chunk_times[0] - t0) * 1e3, 3)
                reply.phases["client_itl_ms_samples"] = [
                    round((b - a) * 1e3, 3) for a, b in
                    zip(chunk_times, chunk_times[1:])]
            if reply.status == "timeout" and i + 1 < attempts:
                last_err = "server timeout: %s" % reply.error
                last_reply = reply
                self._abort_pair(ep, decode_ep, req_id)
                req_id = fresh_id()
                continue
            if reply.status == "shed" and sheds < shed_cap \
                    and i + 1 < attempts:
                last_err = "shed: %s" % reply.error
                last_reply = reply
                self._shed_backoff(reply, sheds)
                sheds += 1
                req_id = fresh_id()
                continue
            root.annotate(status=reply.status, endpoint=ep,
                          attempts=i + 1).end()
            return reply
        if last_reply is not None:
            root.annotate(status=last_reply.status, attempts=attempts).end()
            return last_reply
        root.annotate(status="dropped", attempts=attempts).end()
        return InferReply(
            "dropped", error="all %d attempts failed: %s"
            % (attempts, last_err),
            latency_ms=(time.perf_counter() - t0) * 1e3)

    def generate_stream(self, model, prompt_ids, **kw):
        """Generator of (index, token), indices 0, 1, ... each once; the
        final InferReply is its StopIteration value."""
        got = []
        kw["stream"] = True
        kw["on_token"] = lambda i, t: got.append((i, t))
        reply = self.generate(model, prompt_ids, **kw)
        yield from got
        return reply
