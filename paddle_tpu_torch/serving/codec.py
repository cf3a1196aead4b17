"""Wire codec for the serving protocol (serving/server.py + client.py).

A copy of ``paddle_tpu/serving/codec.py``: the same keys and the same
bytes for the same meta and arrays, so the two packages' clients and
servers read each other's frames, the kvxfer, pair and resume frames of
``serving/disagg.py`` and ``serving/migrate.py`` (either package's, as
named below) among them.  The ``TRACEPARENT`` key carries the client
root span's context (``core/tracing.py``), and a reply meta echoes it
beside the engine's ``phases``.

The native tensor-RPC transport (native/rpc.py) moves ONE named ndarray
per frame; an inference request/reply carries several arrays of mixed
dtype plus metadata (model, tenant, deadline, status).  This codec packs
that bundle into a single uint8 tensor: an 8-byte little-endian header
length, a JSON header (metadata + per-array dtype/shape), then the raw
array bytes concatenated — so one ``send_var``/``get_var`` round trip
moves a whole request, and the existing framing/dedupe/retry machinery
applies unchanged.

Wire keys (PS-style __dunder__ namespace, next to ``__metrics__`` and the
elastic ``__alive__``):

  ``__infer__:<req_id>``   client -> server, packed request
                           meta: model / tenant / req_id / deadline_ms
  ``__reply__:<req_id>``   server -> client, packed reply
                           meta: status ok|shed|timeout|error,
                           retry_after_ms on shed, outputs name order
  ``__spec__:<model>``     server-published feed/fetch signature + buckets
                           (loadgen synthesizes valid feeds from it)
  ``__generate__:<id>``    autoregressive request: prompt ids array +
                           meta model / max_new_tokens / stream
  ``__stream__:<id>:<k>``  k-th generated-token chunk (meta token / i /
                           done / status); the client's parked GETs walk
                           k = 0, 1, ... until done — token-level TTFT
                           and inter-token latency fall out client-side
  ``__abort__:<id>``       client gave up (timeout replay): the decode
                           engine drops the sequence and frees its paged
                           KV blocks so an abandoned prefill can't pin
                           the pool

Control-plane keys:

  ``__retire__``           coordinator -> replica: stop admitting, drain
                           the queue at a batch boundary, then exit (the
                           autoscaler's graceful scale-down path)
  ``__rollout__``          per-replica published rollout state (packed
                           {"models": {base: {active/canary/fraction/
                           state}}}) — the chaos leg GETs it from every
                           survivor to assert version agreement
  ``__rollout_set__``      coordinator -> replica state broadcast (same
                           payload); idempotent, re-sent periodically so
                           a replica that missed a flip converges
  ``__rollout_ctl__:<id>`` client -> coordinator admin command
                           (start/flip/abort/status); the reply lands on
                           ``__reply__:<id>`` like any request

Disaggregated prefill/decode keys:

  ``__kvxfer__:<id>``      prefill -> decode sealed-KV-block stream, one
                           frame per sealed block plus bracketing control
                           frames, all sent on one FIFO connection so
                           arrival order == send order.  Frame kinds
                           (meta ``kind``): "expect" (req announced, arms
                           the orphan janitor), "block" (payload arrays:
                           k/v [L, block, H, D] in the pool's residency
                           dtype, plus k/v scales [L, block, H] when
                           int8; meta carries the hash-chain ``pos`` and
                           ``digest``), "commit" (full prompt + decode
                           params + prefill-side phase timings; the
                           decode replica submits from here), "cancel"
                           (prefill-side abort/shed/timeout: the decode
                           half frees any adopted blocks and publishes
                           the terminal reply).  Packed by
                           ``pack_kvxfer`` and validated LOUDLY by
                           ``unpack_kvxfer`` — a truncated frame or a
                           hash-chain position mismatch raises instead
                           of adopting garbage into the KV pool.
  ``__pair__:<req_id>``    prefill-replica-published routing hint: meta
                           {"decode": "host:port" | None}.  The client
                           GETs it right after ``__generate__`` and walks
                           ``__stream__``/``__reply__`` on the decode
                           half; None means the replica serves the
                           request itself (monolith fallback).

Live session migration keys (serving/migrate.py):

  ``__resume__:<id>``      client -> survivor crash-resume: original
                           prompt + every token already received; the
                           engine re-admits the sequence against its
                           prefix index (full-history hash chain) and
                           continues emitting at the next token index —
                           never re-emitting a token the client holds.
  ``__resumeack__:<id>``   migration destination -> source verdict for a
                           kind=session hand-off ("resumed" | an error
                           status); the source commits (frees the
                           victim's blocks, finishes it "migrated") on
                           "resumed" and falls back to local recompute
                           on anything else.

Requests carry their SLO tier in the meta under ``TIER`` ("paid" /
"free" / "batch"); the engine's deadline-weighted admission sheds
low-weight tiers first under overload, counted per tier in
``serving_tier_shed_total{tier}``.

Distributed tracing (core/tracing.py) rides the meta under the
``TRACEPARENT`` key: the client stamps its root span's W3C-style
``traceparent`` into the request meta, the server parents its admission
span under it, and the reply meta echoes it (plus per-phase timings under
``"phases"``) so one trace_id spans client and replica processes.
"""

import json

import numpy as np

__all__ = ["pack", "unpack", "pack_kvxfer", "unpack_kvxfer",
           "INFER_KEY", "REPLY_KEY", "SPEC_KEY",
           "ALIVE_KEY", "GEN_KEY", "STREAM_KEY", "ABORT_KEY",
           "RETIRE_KEY", "ROLLOUT_KEY", "ROLLOUT_SET_KEY",
           "ROLLOUT_CTL_KEY", "KVXFER_KEY", "PAIR_KEY",
           "RESUME_KEY", "RESUME_ACK_KEY",
           "TRACEPARENT", "TIER"]

INFER_KEY = "__infer__:"
REPLY_KEY = "__reply__:"
SPEC_KEY = "__spec__:"
ALIVE_KEY = "__alive__"
# autoregressive decode: request, per-token stream chunks (suffixed
# ":<index>"), and client-side abandonment (frees the paged KV blocks)
GEN_KEY = "__generate__:"
STREAM_KEY = "__stream__:"
ABORT_KEY = "__abort__:"
# serving control plane: autoscaler drain-and-exit order, rollout state
# (published per replica / broadcast by the coordinator), admin commands
RETIRE_KEY = "__retire__"
ROLLOUT_KEY = "__rollout__"
ROLLOUT_SET_KEY = "__rollout_set__"
ROLLOUT_CTL_KEY = "__rollout_ctl__:"
# disaggregated serving: sealed-KV-block transfer frames (prefill ->
# decode) and the per-request pair-routing hint the client GETs
KVXFER_KEY = "__kvxfer__:"
PAIR_KEY = "__pair__:"
# live session migration (serving/migrate.py): a crash-resume request
# (client -> survivor; arrays [prompt, tokens-already-received], meta
# model / max_new_tokens / eos_id / stream / tier) lands under
# __resume__:<req_id>; a migration destination publishes its admit/
# reject verdict under __resumeack__:<req_id> for the source to GET
# (separate key so a replica's poll loop never consumes its own ack)
RESUME_KEY = "__resume__:"
RESUME_ACK_KEY = "__resumeack__:"
# meta key carrying the W3C-style trace context across the wire
TRACEPARENT = "traceparent"
# meta key carrying the request's SLO tier (paid|free|batch)
TIER = "tier"


def pack(meta, arrays=()):
    """(meta dict, [ndarray, ...]) -> one uint8 ndarray."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = json.dumps({
        "meta": meta,
        "arrays": [{"dtype": a.dtype.str, "shape": list(a.shape)}
                   for a in arrays],
    }).encode("utf-8")
    parts = [len(header).to_bytes(8, "little"), header]
    parts.extend(a.tobytes() for a in arrays)
    return np.frombuffer(b"".join(parts), dtype=np.uint8).copy()


def unpack(arr):
    """Inverse of pack: uint8 ndarray -> (meta dict, [ndarray, ...])."""
    buf = np.ascontiguousarray(np.asarray(arr, dtype=np.uint8)).tobytes()
    hlen = int.from_bytes(buf[:8], "little")
    head = json.loads(buf[8:8 + hlen].decode("utf-8"))
    out, off = [], 8 + hlen
    for spec in head["arrays"]:
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        n = dt.itemsize * int(np.prod(shape, dtype=np.int64)) \
            if shape else dt.itemsize
        out.append(np.frombuffer(buf[off:off + n], dtype=dt)
                   .reshape(shape).copy())
        off += n
    return head["meta"], out


# -- sealed-KV-block transfer frames ------------------------------------------
#
# KV payloads are adopted straight into a decode replica's paged pool, so
# unlike the best-effort request path these frames are validated loudly:
# a frame whose byte count disagrees with its header (truncation,
# mid-write connection loss) or whose hash-chain position is not the one
# the receiver expects raises ValueError instead of quietly corrupting
# the pool.  ``kvxfer`` magic + declared payload length make both checks
# cheap and unambiguous.

_KVXFER_KINDS = ("expect", "block", "commit", "cancel", "session")


def pack_kvxfer(meta, arrays=()):
    """Pack one transfer frame.  ``meta`` must carry ``kind`` (one of
    expect|block|commit|cancel|session) and ``req_id``; block frames
    additionally ``pos`` (hash-chain block index) and ``digest`` (sha256
    hex).  A ``session`` frame carries a live-migration manifest
    (serving/migrate.py): arrays [prompt, emitted tokens] plus meta
    model / position / sealed-block digests / tail descriptor — it is
    sent LAST on the stream, after the session's block frames, so the
    receiver resumes only once every sealed block has landed."""
    kind = meta.get("kind")
    if kind not in _KVXFER_KINDS:
        raise ValueError("kvxfer frame kind must be one of %s, got %r"
                         % ("|".join(_KVXFER_KINDS), kind))
    if not meta.get("req_id"):
        raise ValueError("kvxfer frame meta wants a req_id")
    if kind == "block":
        pos = meta.get("pos")
        if not isinstance(pos, int) or pos < 0:
            raise ValueError("kvxfer block frame wants pos >= 0, got %r"
                             % (pos,))
        digest = meta.get("digest")
        if not (isinstance(digest, str) and len(digest) == 64):
            raise ValueError("kvxfer block frame wants a sha256 hex "
                             "digest, got %r" % (digest,))
    arrays = [np.ascontiguousarray(a) for a in arrays]
    m = dict(meta)
    m["kvxfer"] = 1
    m["payload_bytes"] = int(sum(a.nbytes for a in arrays))
    return pack(m, arrays)


def unpack_kvxfer(arr, expect_pos=None):
    """Inverse of pack_kvxfer with loud validation.

    Raises ValueError on anything short of a byte-exact frame: missing
    kvxfer magic, a declared payload length that disagrees with the
    actual byte count (truncated frame), or — when ``expect_pos`` is
    given — a block frame whose hash-chain ``pos`` is not the expected
    next position (out-of-order / dropped frame on the stream)."""
    buf = np.ascontiguousarray(np.asarray(arr, dtype=np.uint8)).tobytes()
    if len(buf) < 8:
        raise ValueError("kvxfer frame truncated: %d bytes is shorter "
                         "than the 8-byte header length" % len(buf))
    hlen = int.from_bytes(buf[:8], "little")
    if 8 + hlen > len(buf):
        raise ValueError("kvxfer frame truncated: header wants %d bytes,"
                         " frame holds %d" % (8 + hlen, len(buf)))
    try:
        head = json.loads(buf[8:8 + hlen].decode("utf-8"))
        meta, arrays = head["meta"], head["arrays"]
    except Exception as e:
        raise ValueError("kvxfer frame header unreadable: %s" % e)
    if meta.get("kvxfer") != 1:
        raise ValueError("not a kvxfer frame (missing kvxfer magic)")
    declared = int(meta.get("payload_bytes", -1))
    actual = len(buf) - 8 - hlen
    if declared != actual:
        raise ValueError("kvxfer frame truncated: header declares %d "
                         "payload bytes, frame holds %d"
                         % (declared, actual))
    want = 0
    for spec in arrays:
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        want += dt.itemsize * int(np.prod(shape, dtype=np.int64)) \
            if shape else dt.itemsize
    if want != actual:
        raise ValueError("kvxfer frame truncated: array specs want %d "
                         "bytes, frame holds %d" % (want, actual))
    if expect_pos is not None and meta.get("kind") == "block" \
            and int(meta.get("pos", -1)) != int(expect_pos):
        raise ValueError("kvxfer hash-chain position mismatch: got pos="
                         "%r, expected %d (block stream for req %s is "
                         "out of order)"
                         % (meta.get("pos"), expect_pos,
                            meta.get("req_id")))
    return unpack(arr)
