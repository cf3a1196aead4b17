"""Disaggregated prefill and decode of the port: sealed KV blocks streamed
from a prefill-role replica to a decode-role replica.

Counterpart of ``paddle_tpu/serving/disagg.py``, with the same frames,
digests and counters, so either half may be a replica of either package.
A prefill-role replica feeds a prompt up to its last full-block boundary
(``DecodeEngine.submit(handoff=True)``).  As each full prompt block seals
(the engine's ``on_block_sealed`` hook) its payload is copied off the
pools (``PagedKVCache.export_block``) and streamed to the paired decode
replica as a ``__kvxfer__`` frame; at the boundary (``on_handoff``) a
commit frame follows with the whole prompt, the decode parameters and
the prefill half's phase times.  The decode replica adopts each block
into its own refcounted pool under the same digest
(``DecodeEngine.adopt_kv_block``), and the commit's ordinary submit
prefix-matches the adopted blocks like a local cache hit.  The wire
dtype is the pools' (f32, or int8 with its scales beside the payload).

Sender states, by request: ``prefill`` (registered, feeding),
``streaming`` (a block frame queued or sent), ``adopted`` (the commit
went out; the decode half owns the request).

Reconciliation, so a kill on either side frees the blocks on both:

- the prefill side ends a request without a handoff (abort, shed,
  timeout, error): a ``cancel`` frame relays its reply; the decode half
  forgets the adopted digests and publishes the reply the client waits
  on;
- the prefill replica is SIGKILLed mid-transfer: the decode half's orphan
  janitor (``AdoptTracker``) sees an uncommitted adoption whose prefill
  endpoint stopped answering ``__alive__``, frees its blocks and
  publishes a "timeout" reply, which the client replays;
- the decode half dies: the client's stream GET fails, and it aborts both
  halves before replaying.

The sender remembers the digests it shipped to each decode endpoint (an
LRU), so a warm peer is skipped; the receiver answers "cached" for a
digest it indexes already.  A skipped or refused block only costs the
decode half a recompute, since the commit carries the whole prompt.
``kv_xfer_bytes_total{dtype}`` counts whole frame bytes by wire dtype.
"""

import threading
import time
from collections import OrderedDict, deque

from ..core import telemetry as _tm
from ..core import tracing as _tr
from ..native.rpc import RpcClient, probe
from . import codec

__all__ = ["KVBlockSender", "AdoptTracker"]

# digests shipped to a decode endpoint, an LRU an endpoint
_SHIPPED_CAP = 4096
# an uncommitted adoption younger than this is never probed (prefill
# queueing can take a few hundred ms)
_ORPHAN_GRACE_S = 2.0
# a stale entry's prefill endpoint is probed with a capped exponential
# backoff: each probe that finds it alive doubles the wait for the next
_PROBE_BACKOFF_S = 0.5
_PROBE_BACKOFF_CAP_S = 8.0
# an uncommitted adoption older than this is reaped even while its prefill
# half answers (a wedged sender, a commit lost), and this is the only
# reaper of an entry that never learned its prefill endpoint
_ORPHAN_HARD_S = 30.0


class KVBlockSender:
    """The prefill side's sender: one queue and one thread a process, so
    a request's expect, block (pos 0..n) and commit frames reach the peer
    in order (``send_var`` returns once the receiver queued the frame)."""

    def __init__(self):
        self._q = deque()
        self._cond = threading.Condition()
        self._clients = {}              # endpoint -> RpcClient
        self._shipped = {}              # endpoint -> OrderedDict(digest)
        self._reqs = {}                 # req_id -> {"peer", "state", ...}
        # one frame at a time on a connection: the expect frames go out
        # on the server's thread, the rest on this sender's
        self._wire = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._run,
                                        name="kvxfer-send", daemon=True)
        self._thread.start()

    def register(self, req_id, peer, model, wire_dtype):
        with self._cond:
            self._reqs[req_id] = {"peer": peer, "state": "prefill",
                                  "model": model, "dtype": wire_dtype}

    def send_expect_now(self, req_id, meta):
        """The expect frame, sent on the caller's thread before the pair
        is published, so the decode half knows the request (its janitor
        is armed) before any client can learn the pair.  False when the
        peer is unreachable: the caller serves the request itself."""
        with self._cond:
            e = self._reqs.get(req_id)
        if e is None:
            return False
        m = dict(meta)
        m.update(kind="expect", req_id=req_id)
        return self._send(e["peer"], req_id, m, ())

    def enqueue_block(self, req_id, pos, digest, arrays):
        with self._cond:
            e = self._reqs.get(req_id)
            if e is None:
                return
            if e["state"] == "prefill":
                e["state"] = "streaming"
            peer = e["peer"]
            shipped = self._shipped.setdefault(peer, OrderedDict())
            if digest in shipped:
                shipped.move_to_end(digest)
                _tm.inc("kv_xfer_skipped_total", dtype=e["dtype"])
                return          # a warm peer: nothing on the wire
            shipped[digest] = True
            while len(shipped) > _SHIPPED_CAP:
                shipped.popitem(last=False)
            meta = {"kind": "block", "req_id": req_id, "pos": int(pos),
                    "digest": digest, "model": e["model"],
                    "dtype": e["dtype"]}
            self._q.append((peer, req_id, meta, list(arrays)))
            self._cond.notify_all()

    def enqueue_commit(self, req_id, meta):
        with self._cond:
            e = self._reqs.get(req_id)
            if e is None:
                return
            m = dict(meta)
            m.update(kind="commit", req_id=req_id)
            self._q.append((e["peer"], req_id, m, ()))
            self._cond.notify_all()

    def enqueue_cancel(self, req_id, reply_meta):
        """The prefill side ended the request without a handoff: drop its
        queued frames and relay the reply, so the decode half frees its
        adoptions and the parked client gets an answer."""
        with self._cond:
            e = self._reqs.pop(req_id, None)
            if e is None:
                return
            self._q = deque(f for f in self._q if f[1] != req_id)
            meta = {"kind": "cancel", "req_id": req_id,
                    "reply": dict(reply_meta or {})}
            self._q.append((e["peer"], req_id, meta, ()))
            self._cond.notify_all()

    def mark_adopted(self, req_id):
        """The commit went out; the entry stays only so an abort relay
        can find the peer."""
        with self._cond:
            e = self._reqs.get(req_id)
            if e is not None:
                e["state"] = "adopted"

    def forget(self, req_id):
        with self._cond:
            self._reqs.pop(req_id, None)

    def _client(self, peer):
        c = self._clients.get(peer)
        if c is None:
            c = self._clients[peer] = RpcClient(
                peer, connect_timeout=2.0, rpc_deadline=15.0,
                retry_times=0)
        return c

    def _send(self, peer, req_id, meta, arrays):
        frame = codec.pack_kvxfer(meta, arrays)
        # write-through before the send: a SIGKILL mid-transfer leaves
        # the frame in flight named in flightrec-<pid>.json
        _tr.note("kvxfer", frame_kind=meta["kind"], req_id=req_id,
                 peer=peer, pos=meta.get("pos", -1),
                 digest=meta.get("digest", "")[:16])
        with self._wire:
            for _ in range(2):
                try:
                    self._client(peer).send_var(codec.KVXFER_KEY + req_id,
                                                frame)
                    break
                except ConnectionError:
                    # a broken connection: reconnect once, then give up (a
                    # lost frame costs the decode half a recompute, and the
                    # janitor covers a lost commit)
                    dead = self._clients.pop(peer, None)
                    if dead is not None:
                        dead.close()
            else:
                _tm.inc("kv_xfer_send_errors_total")
                return False
        if meta["kind"] == "block":
            _tm.inc("kv_xfer_bytes_total", int(frame.nbytes),
                    dtype=meta.get("dtype", "f32"))
            _tm.inc("kv_xfer_blocks_total", dtype=meta.get("dtype", "f32"))
        _tm.inc("kv_xfer_frames_total", kind=meta["kind"])
        return True

    def _run(self):
        while True:
            with self._cond:
                while self._running and not self._q:
                    self._cond.wait(0.2)
                if not self._running and not self._q:
                    return
                peer, req_id, meta, arrays = self._q.popleft()
            self._send(peer, req_id, meta, arrays)
            if meta["kind"] == "commit":
                self.mark_adopted(req_id)
            elif meta["kind"] == "cancel":
                self.forget(req_id)

    def close(self):
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(5.0)
        with self._wire:
            for c in self._clients.values():
                c.close()
            self._clients.clear()


class AdoptTracker:
    """The decode side's adoption state by request, and the orphan
    janitor.

    An entry lives from the expect (or first block) frame to the commit.
    ``on_orphan(req_id, entry)`` fires for an uncommitted entry whose
    prefill endpoint stops answering ``__alive__`` probes; the server
    then forgets its digests and publishes a "timeout" reply, so the
    parked client replays.  Probes back off exponentially an endpoint
    (capped), and each reaped adoption counts in
    ``kv_xfer_orphans_total{reason=}``: ``dead_peer`` (a probe failed),
    ``timeout`` (uncommitted past the hard cap, the sender alive or
    unknown), ``cancelled`` (a cancel frame after blocks were adopted)."""

    def __init__(self, on_orphan):
        self._entries = {}
        self._lock = threading.Lock()
        self._on_orphan = on_orphan
        self._stop = threading.Event()
        # endpoint -> [next probe interval s, not before (monotonic)],
        # the janitor thread's alone; dropped when a probe fails, so a
        # relaunched peer starts afresh
        self._probe_state = {}
        self._thread = threading.Thread(target=self._janitor,
                                        name="kvxfer-janitor", daemon=True)
        self._thread.start()

    def _entry(self, req_id):
        e = self._entries.get(req_id)
        if e is None:
            e = self._entries[req_id] = {
                "model": None, "digests": [], "next_pos": 0,
                "committed": False, "t0": time.monotonic(),
                "prefill_ep": None}
        return e

    def expect(self, req_id, meta):
        with self._lock:
            e = self._entry(req_id)
            e["model"] = meta.get("model") or e["model"]
            e["prefill_ep"] = meta.get("prefill_ep") or e["prefill_ep"]

    def on_block(self, req_id, meta):
        """Check and record one block frame -> None when it may be
        adopted, else the reason to refuse it.  A skipped position is
        legal (the sender skips digests it shipped); one at or below a
        position already adopted breaks the chain's order."""
        pos = int(meta.get("pos", -1))
        with self._lock:
            e = self._entry(req_id)
            e["model"] = meta.get("model") or e["model"]
            if pos < e["next_pos"]:
                return ("hash-chain position mismatch: pos=%d after "
                        "pos=%d was already adopted"
                        % (pos, e["next_pos"] - 1))
            e["next_pos"] = pos + 1
            e["digests"].append(meta.get("digest"))
            return None

    def commit(self, req_id):
        """The commit arrived: the engine owns the blocks now -> the
        entry."""
        with self._lock:
            e = self._entries.pop(req_id, None)
            if e is not None:
                e["committed"] = True
            return e

    def cancel(self, req_id):
        """A cancel (or an orphan): drop the entry -> it, with the digests
        to forget."""
        with self._lock:
            e = self._entries.pop(req_id, None)
        if e is not None and not e["committed"] and e["digests"]:
            _tm.inc("kv_xfer_orphans_total", reason="cancelled")
        return e

    def _janitor(self):
        while not self._stop.wait(0.5):
            now = time.monotonic()
            with self._lock:
                stale = [(rid, dict(e)) for rid, e in self._entries.items()
                         if not e["committed"]
                         and now - e["t0"] > _ORPHAN_GRACE_S]
            alive = {}
            for rid, e in stale:
                ep = e["prefill_ep"]
                if now - e["t0"] > _ORPHAN_HARD_S:
                    self._reap(rid, "timeout")
                    continue
                if not ep:
                    continue        # the hard timeout is its only reaper
                if ep not in alive:
                    st = self._probe_state.setdefault(
                        ep, [_PROBE_BACKOFF_S, 0.0])
                    if now < st[1]:
                        continue    # inside this endpoint's backoff
                    alive[ep] = probe(ep, codec.ALIVE_KEY,
                                      timeout=1.0) is not None
                    if alive[ep]:
                        st[1] = now + st[0]
                        st[0] = min(_PROBE_BACKOFF_CAP_S, st[0] * 2.0)
                    else:
                        self._probe_state.pop(ep, None)
                if not alive[ep]:
                    self._reap(rid, "dead_peer")

    def _reap(self, rid, reason):
        with self._lock:
            gone = self._entries.pop(rid, None)
        if gone is not None:
            _tm.inc("kv_xfer_orphans_total", reason=reason)
            try:
                self._on_orphan(rid, gone)
            except Exception:  # the janitor keeps running
                pass

    def close(self):
        self._stop.set()
        self._thread.join(3.0)
