"""Live decode-session migration of the port: a generation in flight
moves to another replica and continues there, without re-prefill.

Counterpart of ``paddle_tpu/serving/migrate.py``, with the same frames,
digests and counters, so a session moves between replicas of either
package.  At a step boundary a decoding sequence is a small manifest
(prompt, emitted tokens, feed position p, decode parameters) and the KV
of positions ``[0, p)``, which is content-addressed already: the engine
extends each sequence's prefix chain over its generated tokens and
publishes every completed history block (``DecodeEngine`` under
``FLAGS_session_migration``).  A migration sends the sealed blocks the
peer may lack, one tail block and the manifest; the resume is an
ordinary admission that matches the whole history chain, and greedy
decode makes its continuation the uninterrupted run's tokens.

Frames, on one ``__kvxfer__:<req_id>`` connection, in order:

  block frames    ``kind=block, session=1``: a sealed history block not
                  recently shipped to this peer, adopted on arrival
                  (``DecodeEngine.adopt_kv_block``), so the peer's index
                  stays warm even if the resume is refused
  tail frame      ``kind=block, session=1, tail=1, valid=n``: the partial
                  block past the last sealed boundary, under a digest of
                  its own domain (``tail_digest``) that never equals a
                  chain digest; the peer holds it in a ``ResumeBuffer``
                  until the manifest comes, then installs it into a
                  private block of the resumed sequence, never indexed
  session frame   ``kind=session``, last: the manifest, its arrays
                  [prompt, emitted tokens]; the peer resumes and answers
                  under ``__resumeack__:<req_id>``

Triggers: a client crash resume (``__resume__`` with the tokens it
holds, served by ``ServingServer``), a drain
(``DecodeEngine.drain(migrate=SessionMigrator.drain_push())``) and
pressure (a preempted sequence pushed to the least-loaded peer).

No token twice, none dropped: the source parks its sequence
(``export_session``) until the peer acks "resumed", then finishes it
"migrated" with ``migrated_to`` (the client follows); on any other
outcome it re-queues it locally (``abort_migration``), so at most one
replica runs a session.  The peer refuses a req_id it already runs, a
manifest whose position disagrees with prompt + tokens, and a session
still in prefill at the source.  A resumed sequence emits from index
``len(tokens)``, and the client drops an index it already holds.

Telemetry, the reference's: ``kv_migrate_sessions_total{trigger,model}``,
``kv_migrate_blocks_total`` / ``kv_migrate_bytes_total{dtype}``,
``kv_migrate_skipped_total{dtype}``, ``kv_migrate_failed_total{trigger}``,
``kv_migrate_refused_total{reason}``, ``kv_migrate_resume_total{result}``
and the ``migration_ms`` histogram (export to the peer's ack); the
``migrate`` and ``kvxfer`` notes (``core/tracing.py``).
"""

import hashlib
import threading
import time
from collections import OrderedDict

from .. import flags as _flags
from ..core import telemetry as _tm
from ..core import tracing as _tr
from ..native.rpc import RpcClient
from . import codec

__all__ = ["SessionMigrator", "ResumeBuffer", "tail_digest"]

# digests recently shipped to a peer, an LRU a peer (as the disaggregated
# sender's): a peer warmed by earlier migrations skips the wire
_SHIPPED_CAP = 4096
# a buffered tail older than this is purged: the manifest follows its tail
# on the same connection, so such a gap means the source died
_RESUME_BUF_TTL_S = 60.0


def tail_digest(prev_hex, token_ids):
    """The label of a tail block sealed at migration time: a chain step
    past the last full block's digest under its own domain (``#tail``), so
    it never equals, or matches as, a full block's digest."""
    h = (bytes.fromhex(prev_hex) if prev_hex
         else hashlib.sha256(b"kvtail:").digest())
    d = hashlib.sha256(h)
    d.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                      for t in token_ids))
    d.update(b"#tail")
    return d.hexdigest()


class ResumeBuffer:
    """The destination's holding area for hand-offs in flight: a tail
    payload (host arrays) by req_id until its manifest consumes it, and
    the chain digests the hand-off adopted, so a refused resume can
    forget them.  Stale entries are purged on every touch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}      # req_id -> dict

    def _entry_locked(self, req_id):
        e = self._entries.get(req_id)
        if e is None:
            e = self._entries[req_id] = {
                "tail": None, "tail_valid": 0, "tail_digest": None,
                "digests": [], "t0": time.monotonic()}
        return e

    def _purge_locked(self, now):
        dead = [rid for rid, e in self._entries.items()
                if now - e["t0"] > _RESUME_BUF_TTL_S]
        for rid in dead:
            del self._entries[rid]
            _tm.inc("kv_migrate_refused_total", reason="stale_buffer")

    def note_adopted(self, req_id, digest):
        with self._lock:
            self._purge_locked(time.monotonic())
            self._entry_locked(req_id)["digests"].append(digest)

    def put_tail(self, req_id, digest, valid, arrays):
        with self._lock:
            self._purge_locked(time.monotonic())
            e = self._entry_locked(req_id)
            e["tail"] = list(arrays)
            e["tail_valid"] = int(valid)
            e["tail_digest"] = digest

    def take(self, req_id):
        """Consume the entry (None when the hand-off shipped nothing)."""
        with self._lock:
            return self._entries.pop(req_id, None)


class SessionMigrator:
    """The source's side of a hand-off, around the engine's primitives:

      1. ``engine.export_session(req_id)`` detaches the sequence between
         steps and snapshots manifest and blocks (host copies); the
         engine parks it;
      2. the frames go to the peer on a connection of the hand-off's own
         (blocks, tail, manifest), and the peer's ``__resumeack__`` is
         awaited (``FLAGS_migrate_ack_timeout``);
      3. "resumed": ``commit_migration`` (free, finish "migrated" with
         ``migrated_to``); anything else: ``abort_migration`` (re-queue
         locally).

    ``peers_fn`` (called without a lock held) names candidate endpoints;
    ``occupancy_fn`` (optional, fleetmon-backed) maps endpoint to its
    windowed KV occupancy, so ``pick_peer`` takes the least loaded.  The
    lock guards only the shipped-digest LRUs and the closed flag: no RPC
    and no engine call runs under it."""

    def __init__(self, engine, peers_fn=None, occupancy_fn=None):
        self.engine = engine
        self.peers_fn = peers_fn or (lambda: [])
        self.occupancy_fn = occupancy_fn
        self._lock = threading.Lock()
        self._shipped = {}              # endpoint -> OrderedDict(digest)
        self._closed = False

    def pick_peer(self):
        """The least-loaded live candidate, or None when alone."""
        try:
            peers = list(self.peers_fn() or [])
        except Exception:  # a failing discovery reads as no peer
            peers = []
        if not peers:
            return None
        if self.occupancy_fn is not None:
            try:
                occ = self.occupancy_fn()
                peers.sort(key=lambda p: occ.get(p, 0.5))
            except Exception:  # unsorted: any live peer will do
                pass
        return peers[0]

    def migrate(self, req_id, peer=None, trigger="drain"):
        """Push one live session to ``peer`` (picked when None) -> True
        only when the peer acked "resumed" and the session was committed
        away; on any other outcome it is back in the local scheduler (or
        was never detached).  The engine's loud refusals (unknown, in
        prefill, double migration) raise ValueError and change
        nothing."""
        if peer is None:
            peer = self.pick_peer()
        if peer is None:
            return False
        t0 = time.perf_counter()
        manifest, payloads = self.engine.export_session(req_id)
        ok = False
        try:
            ok = self._push(peer, manifest, payloads)
        finally:
            # commit or abort exactly once, even if the push raised
            if ok:
                self.engine.commit_migration(req_id, peer)
                _tm.inc("kv_migrate_sessions_total", trigger=trigger,
                        model=manifest["model"])
                _tm.observe("migration_ms",
                            (time.perf_counter() - t0) * 1000.0)
                _tr.note("migrate", req_id=req_id, peer=peer,
                         trigger=trigger, pos=manifest["pos"])
            else:
                self.engine.abort_migration(req_id)
                _tm.inc("kv_migrate_failed_total", trigger=trigger)
        return ok

    def drain_push(self, trigger="drain"):
        """The ``migrate`` callback of ``DecodeEngine.drain``: a peer pick
        per session; a refusal reads as False, and drain waits that
        session out."""
        def push(req_id, model):
            del model
            try:
                return self.migrate(req_id, trigger=trigger)
            except ValueError:
                return False
        return push

    def _skip_shipped(self, peer, digest):
        """True when ``digest`` was recently shipped to ``peer`` (LRU
        touch).  Two racing hand-offs may ship one twice; the peer then
        answers "cached"."""
        with self._lock:
            shipped = self._shipped.setdefault(peer, OrderedDict())
            if digest in shipped:
                shipped.move_to_end(digest)
                return True
        return False

    def _mark_shipped(self, peer, digest):
        with self._lock:
            shipped = self._shipped.setdefault(peer, OrderedDict())
            shipped[digest] = True
            while len(shipped) > _SHIPPED_CAP:
                shipped.popitem(last=False)

    def _push(self, peer, manifest, payloads):
        """Blocks, tail and manifest, then the ack, all on one connection
        of this hand-off's own, so the peer sees them in order without a
        lock held across the wire."""
        rid = manifest["req_id"]
        model = manifest["model"]
        dtype = manifest.get("dtype", "f32")
        # the token arrays ride the session frame's payload
        p_arr = manifest.pop("_prompt_arr")
        o_arr = manifest.pop("_out_arr")
        with self._lock:
            if self._closed:
                return False
        ack_s = float(_flags.flag("migrate_ack_timeout") or 10.0)
        try:
            cli = RpcClient(peer, connect_timeout=2.0,
                            rpc_deadline=max(ack_s, 5.0), retry_times=0)
        except ConnectionError:
            return False
        try:
            for pos, digest, arrays, is_tail in payloads:
                if not is_tail and self._skip_shipped(peer, digest):
                    _tm.inc("kv_migrate_skipped_total", dtype=dtype)
                    continue
                meta = {"kind": "block", "req_id": rid, "pos": int(pos),
                        "digest": digest, "model": model, "dtype": dtype,
                        "session": 1}
                if is_tail:
                    meta["tail"] = 1
                    meta["valid"] = int(manifest["pos"]
                                        - pos * manifest["block_size"])
                frame = codec.pack_kvxfer(meta, arrays)
                _tr.note("kvxfer", frame_kind="session-block", req_id=rid,
                         peer=peer, pos=int(pos), digest=digest[:16])
                cli.send_var(codec.KVXFER_KEY + rid, frame)
                if not is_tail:
                    self._mark_shipped(peer, digest)
                _tm.inc("kv_migrate_blocks_total", dtype=dtype)
                _tm.inc("kv_migrate_bytes_total", int(frame.nbytes),
                        dtype=dtype)
            sframe = codec.pack_kvxfer(dict(manifest, kind="session"),
                                       [p_arr, o_arr])
            _tr.note("kvxfer", frame_kind="session", req_id=rid, peer=peer,
                     pos=int(manifest["pos"]), digest="")
            cli.send_var(codec.KVXFER_KEY + rid, sframe)
            ack = cli.get_var(codec.RESUME_ACK_KEY + rid)
        except (ConnectionError, ValueError):
            return False
        finally:
            cli.close()
        try:
            meta, _ = codec.unpack(ack)
        except (ValueError, KeyError, UnicodeDecodeError):
            return False
        return meta.get("status") == "resumed"

    def close(self):
        """Refuse new hand-offs; pushes in flight end on their own bounded
        connections."""
        with self._lock:
            self._closed = True
