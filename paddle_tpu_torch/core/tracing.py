"""Distributed tracing: cross-process request and step spans, and the
flight recorder.

A port of ``paddle_tpu/core/tracing.py``, record for record: the same
span, instant, note and process-header layout (keys ``t``, ``name``,
``tid``, ``sid``, ``parent``, ``ts``, ``dur``, ``thr``, ``attrs``,
``links``; the ``proc`` header's ``pid`` and ``name``), the same
``traceparent`` strings and the same ``\x1f`` frame-name separator, so a
trace that crosses the two packages joins up and the reference's
``tools/trace_view.py`` merges the port's files beside its own.

- **spans**: trace_id (32 hex) / span_id (16 hex) / parent_id, wall-clock
  start (``time.time``) and monotonic duration (``perf_counter``), free
  ``attrs``, and ``links`` to other spans (a serving batch span links the
  request spans it serves).  A thread-local stack parents nested spans;
  ``activate()`` pushes an existing span so work on another thread (the
  serving dispatcher running the executor) nests under it.
- **propagation**: ``traceparent`` strings (``00-<trace>-<span>-01``)
  ride the serving codec meta and are stamped onto RPC SEND frame names
  (``native/rpc.py``); ``remote_parent()`` opens spans under a context
  received off the wire.
- **sink**: one JSONL stream per process, ``trace-<pid>.jsonl`` under
  ``FLAGS_telemetry_dir``, bounded by ``FLAGS_telemetry_max_bytes``
  (telemetry's ``_RotatingFile``, as ``steps.jsonl``).
- **off costs one flag read**: ``FLAGS_tracing`` is off by default; every
  public call returns after one flag read, handing back the shared inert
  ``_NULL_SPAN``.  No file, no thread state, no signal handler.
- **flight recorder**: a ring of the last 512 records plus write-through
  ``note()`` breadcrumbs, dumped to ``<telemetry_dir>/flightrec-<pid>.json``
  at every note (a fired fault point notes), on an unhandled exception,
  on SIGTERM and at exit.  SIGKILL cannot be caught, so ``note()`` puts
  the ring on disk at once: a killed replica leaves its in-flight batch
  or decode step behind.
"""

import atexit
import json
import os
import sys
import threading
import time

__all__ = [
    "enabled", "Span", "start_span", "span", "activate", "remote_parent",
    "record_span", "instant", "current_span", "current_context",
    "traceparent", "parse_traceparent", "set_process_name", "note",
    "flight_dump", "flush", "reset",
]

_FLIGHT_CAP = 512          # ring slots kept for the postmortem dump
_WIRE_SEP = "\x1f"         # RPC frame-name separator for the traceparent

_lock = threading.RLock()
_tls = threading.local()   # .stack = [Span, ...] per thread
_sink = [None, None]       # (path, _RotatingFile) — telemetry's sink idiom
_proc_name = [None]        # explicit process track name (torch_serve.py)
_proc_header_written = [False]
_flight = []               # bounded ring of record dicts
_handlers_installed = [False]
_rng_state = [None]        # (pid, counter) — fork-safe id generation


_flags_mod = [None]        # cached flags module (import once, read often)


def _flags():
    m = _flags_mod[0]
    if m is None:
        from .. import flags as m

        _flags_mod[0] = m
    return m


def enabled():
    """One flag read — the telemetry.enabled() guard pattern."""
    return bool(_flags().flag("tracing"))


def _telemetry_dir():
    return _flags().flag("telemetry_dir") or ""


def _new_id(nbytes):
    # os.urandom per id is measurably slow; draw from a per-process
    # counter folded with startup entropy (fork-safe: keyed by pid)
    pid = os.getpid()
    with _lock:
        st = _rng_state[0]
        if st is None or st[0] != pid:
            st = [pid, int.from_bytes(os.urandom(8), "little")]
            _rng_state[0] = st
        st[1] = (st[1] * 6364136223846793005 + 1442695040888963407) \
            % (1 << 64)
        v = st[1]
        if nbytes > 8:
            st[1] = (st[1] * 6364136223846793005 + 1442695040888963407) \
                % (1 << 64)
            v = (v << 64) | st[1]
    h = "%0*x" % (2 * nbytes, v)
    return h[-2 * nbytes:]


# -- W3C-style context --------------------------------------------------------

def parse_traceparent(tp):
    """``00-<32 hex trace>-<16 hex span>-<flags>`` -> (trace_id, span_id)
    or None on anything malformed (a bad header never breaks a request)."""
    if not isinstance(tp, str):
        return None
    parts = tp.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return parts[1], parts[2]


def _format_traceparent(trace_id, span_id):
    return "00-%s-%s-01" % (trace_id, span_id)


def current_span():
    """Innermost active span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_context():
    """(trace_id, span_id) of the innermost active span, or None."""
    s = current_span()
    return (s.trace_id, s.span_id) if s is not None else None


def traceparent():
    """Serialized context of the current span for the wire, or None."""
    s = current_span()
    return _format_traceparent(s.trace_id, s.span_id) if s else None


# -- spans --------------------------------------------------------------------

class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_wall",
                 "_t0", "dur_ms", "attrs", "links", "thread", "_ended")

    def __init__(self, name, trace_id=None, parent_id=None, **attrs):
        self.name = name
        self.trace_id = trace_id or _new_id(16)
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self.dur_ms = None
        self.attrs = dict(attrs) if attrs else {}
        self.links = []
        self.thread = threading.current_thread().name
        self._ended = False

    def annotate(self, **attrs):
        self.attrs.update(attrs)
        return self

    def link(self, other):
        """Associate another span (same- or cross-trace) without
        parenting it — e.g. a batch span linking the requests it serves."""
        if isinstance(other, Span):
            self.links.append([other.trace_id, other.span_id])
        elif other:  # (trace_id, span_id) tuple
            self.links.append([other[0], other[1]])
        return self

    @property
    def context(self):
        return (self.trace_id, self.span_id)

    @property
    def traceparent(self):
        return _format_traceparent(self.trace_id, self.span_id)

    def end(self):
        if self._ended:
            return self
        self._ended = True
        self.dur_ms = (time.perf_counter() - self._t0) * 1e3
        _emit(self._record())
        return self

    def _record(self):
        rec = {"t": "span", "name": self.name, "tid": self.trace_id,
               "sid": self.span_id, "parent": self.parent_id,
               "ts": int(self.t_wall * 1e6),
               "dur": int((self.dur_ms or 0.0) * 1e3),
               "thr": self.thread}
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.links:
            rec["links"] = self.links
        return rec


class _NullSpan:
    """Inert span handed out when FLAGS_tracing is off: every method is a
    cheap no-op so call sites never branch on the flag themselves."""

    __slots__ = ()
    trace_id = span_id = parent_id = None
    context = None
    traceparent = None
    dur_ms = None

    def annotate(self, **attrs):
        return self

    def link(self, other):
        return self

    def end(self):
        return self


_NULL_SPAN = _NullSpan()


def _push(s):
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(s)


def _pop(s):
    stack = getattr(_tls, "stack", None)
    if stack and stack[-1] is s:
        stack.pop()
    elif stack and s in stack:   # out-of-order end: drop it anyway
        stack.remove(s)


def start_span(name, parent=None, **attrs):
    """Open a span (NOT pushed on the thread stack — pair with .end(), or
    use the ``span()`` context manager for stack semantics).  ``parent``
    may be a Span, a (trace_id, span_id) tuple, or None (defaults to the
    current thread's innermost span; a root span otherwise)."""
    if not enabled():
        return _NULL_SPAN
    if parent is None:
        parent = current_span()
    if isinstance(parent, Span):
        return Span(name, trace_id=parent.trace_id,
                    parent_id=parent.span_id, **attrs)
    if isinstance(parent, _NullSpan):
        parent = None
    if parent:  # (trace_id, span_id)
        return Span(name, trace_id=parent[0], parent_id=parent[1], **attrs)
    return Span(name, **attrs)


class _SpanCtx:
    """Context manager that pushes the span on this thread's stack (so
    nested spans parent under it) and ends it on exit."""

    __slots__ = ("span",)

    def __init__(self, s):
        self.span = s

    def __enter__(self):
        if self.span is not _NULL_SPAN:
            _push(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if self.span is not _NULL_SPAN:
            if exc is not None:
                self.span.annotate(error=str(exc)[:200])
            _pop(self.span)
            self.span.end()
        return False


def span(name, parent=None, **attrs):
    """``with tracing.span("serving.execute", bucket=4) as s: ...`` —
    opens, stacks, and ends a span around the block."""
    return _SpanCtx(start_span(name, parent=parent, **attrs))


class _ActivateCtx:
    """Push an EXISTING span on this thread's stack without ending it on
    exit — used to parent executor spans under the serving batch span
    that lives on the dispatcher thread."""

    __slots__ = ("span",)

    def __init__(self, s):
        self.span = s

    def __enter__(self):
        if isinstance(self.span, Span):
            _push(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if isinstance(self.span, Span):
            _pop(self.span)
        return False


def activate(s):
    return _ActivateCtx(s)


def remote_parent(tp):
    """Context manager: open a span factory under a wire context.  Usage:
    ``with tracing.remote_parent(meta.get("traceparent")): ...`` — spans
    started inside parent under the remote caller's span.  A missing or
    malformed header degrades to local-root semantics."""
    ctx = parse_traceparent(tp) if tp else None
    if not enabled() or ctx is None:
        return _ActivateCtx(_NULL_SPAN)
    anchor = Span.__new__(Span)  # stack anchor only, never emitted
    anchor.name = "<remote>"
    anchor.trace_id, anchor.span_id = ctx
    anchor.parent_id = None
    anchor.t_wall = time.time()
    anchor._t0 = time.perf_counter()
    anchor.dur_ms = None
    anchor.attrs = {}
    anchor.links = []
    anchor.thread = threading.current_thread().name
    anchor._ended = True  # end() can never re-emit it
    return _ActivateCtx(anchor)


def record_span(name, wall_start_s, dur_ms, parent=None, trace_id=None,
                links=None, **attrs):
    """Emit a span RETROACTIVELY from measured timestamps (phases
    measured as perf_counter deltas first, then laid out as a span tree).
    ``links`` associates other spans without parenting them — each entry
    a Span or (trace_id, span_id) tuple.  Returns the span (already
    ended)."""
    if not enabled():
        return _NULL_SPAN
    if isinstance(parent, Span):
        trace_id, parent_id = parent.trace_id, parent.span_id
    elif isinstance(parent, (tuple, list)) and len(parent) == 2:
        trace_id, parent_id = parent
    else:
        parent_id = None
    s = Span.__new__(Span)
    s.name = name
    s.trace_id = trace_id or _new_id(16)
    s.span_id = _new_id(8)
    s.parent_id = parent_id
    s.t_wall = float(wall_start_s)
    s._t0 = None
    s.dur_ms = float(dur_ms)
    s.attrs = dict(attrs) if attrs else {}
    s.links = []
    for other in (links or ()):
        if other is not None and not isinstance(other, _NullSpan):
            s.link(other)
    s.thread = threading.current_thread().name
    s._ended = True
    _emit(s._record())
    return s


def instant(name, **attrs):
    """Point-in-time marker on the current trace."""
    if not enabled():
        return
    rec = {"t": "inst", "name": name, "ts": int(time.time() * 1e6),
           "thr": threading.current_thread().name}
    ctx = current_context()
    if ctx is not None:
        rec["tid"], rec["sid"] = ctx
    if attrs:
        rec["attrs"] = attrs
    _emit(rec)


def set_process_name(name):
    """Name this process's track in the merged trace (e.g.
    ``serving-replica-0``); defaults to ``pid-<pid>``."""
    _proc_name[0] = str(name)
    _proc_header_written[0] = False  # re-announce under the new name


# -- sink ---------------------------------------------------------------------

def _proc_header():
    return {"t": "proc", "pid": os.getpid(),
            "name": _proc_name[0] or ("pid-%d" % os.getpid()),
            "ts": int(time.time() * 1e6)}


def _sink_fh(d):
    from .telemetry import _RotatingFile

    path = os.path.join(d, "trace-%d.jsonl" % os.getpid())
    if _sink[0] != path:
        if _sink[1] is not None:
            _sink[1].close()
        try:
            os.makedirs(d, exist_ok=True)
            _sink[0] = path
            _sink[1] = _RotatingFile(path)
            _proc_header_written[0] = False
        except OSError:
            _sink[0] = _sink[1] = None
    return _sink[1]


def _emit(rec):
    _install_handlers()
    with _lock:
        _flight.append(rec)
        if len(_flight) > _FLIGHT_CAP:
            del _flight[: len(_flight) - _FLIGHT_CAP]
        d = _telemetry_dir()
        if not d:
            return
        fh = _sink_fh(d)
        if fh is None:
            return
        if not _proc_header_written[0]:
            _proc_header_written[0] = True
            fh.write(json.dumps(_proc_header()) + "\n")
        fh.write(json.dumps(rec, default=str) + "\n")
        fh.flush()
    if _telemetry_enabled():
        from . import telemetry as _tm

        _tm.inc("tracing_records_total", kind=rec["t"])


def _telemetry_enabled():
    from . import telemetry as _tm

    return _tm.enabled()


def flush():
    """Flush the JSONL sink (tests; the stream is flushed per record
    already, this also covers a swapped telemetry_dir)."""
    with _lock:
        if _sink[1] is not None:
            _sink[1].flush()


def reset():
    """Tests: drop the sink, the flight ring, and per-thread stacks are
    left to unwind naturally (they are context-managed)."""
    with _lock:
        if _sink[1] is not None:
            _sink[1].close()
        _sink[0] = _sink[1] = None
        _proc_header_written[0] = False
        _flight[:] = []


# -- flight recorder ----------------------------------------------------------

def note(kind, **fields):
    """Write-through breadcrumb: lands in the flight ring AND immediately
    checkpoints the ring to flightrec-<pid>.json.  The serving engine
    notes each batch's req_ids here right before execute — SIGKILL is
    uncatchable, so the postmortem must already be on disk when it hits."""
    if not enabled():
        return
    rec = {"t": "note", "kind": kind, "ts": int(time.time() * 1e6),
           "thr": threading.current_thread().name}
    ctx = current_context()
    if ctx is not None:
        rec["tid"], rec["sid"] = ctx
    if fields:
        rec.update(fields)
    _emit(rec)
    flight_dump(reason="note:" + kind)


def flight_dump(reason="manual"):
    """Atomically write the flight ring to <telemetry_dir>/
    flightrec-<pid>.json.  Returns the path, or None (off / no dir)."""
    if not enabled():
        return None
    d = _telemetry_dir()
    if not d:
        return None
    path = os.path.join(d, "flightrec-%d.json" % os.getpid())
    with _lock:
        doc = {"proc": _proc_header(), "reason": reason,
               "dumped_at": int(time.time() * 1e6),
               "records": list(_flight)}
    tmp = path + ".tmp"
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
    except OSError:
        return None
    if _telemetry_enabled():
        from . import telemetry as _tm

        _tm.inc("tracing_flightrec_dumps_total",
                reason=reason.split(":", 1)[0])
    return path


def _install_handlers():
    """Lazy, once: atexit + excepthook always; SIGTERM only from the main
    thread (signal.signal raises elsewhere) and chaining any prior
    handler so torch_serve.py's graceful-shutdown handler still runs."""
    if _handlers_installed[0]:
        return
    with _lock:
        if _handlers_installed[0]:
            return
        _handlers_installed[0] = True
    atexit.register(lambda: flight_dump(reason="atexit"))

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            flight_dump(reason="exception:%s" % exc_type.__name__)
        except Exception:
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook
    if threading.current_thread() is threading.main_thread():
        import signal

        try:
            prev = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                try:
                    flight_dump(reason="sigterm")
                except Exception:
                    pass
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, on_term)
        except (ValueError, OSError):
            pass


# -- RPC frame-name stamping (native/rpc.py) ----------------------------------

def stamp_wire_name(name):
    """Append the current trace context to an RPC SEND frame name
    (``<name>\\x1f<traceparent>``) — only when tracing is on AND a span is
    active, so heartbeats/control traffic outside any trace stay
    byte-identical on the wire.  The 1024-byte name buffer fits any
    protocol key plus the 55-char header."""
    if not enabled():
        return name
    tp = traceparent()
    if tp is None or len(name) + len(tp) + 1 > 1000:
        return name
    return name + _WIRE_SEP + tp


def strip_wire_name(name):
    """Inverse of stamp_wire_name on the poll side: returns
    (bare_name, traceparent_or_None)."""
    if _WIRE_SEP not in name:
        return name, None
    bare, _, tp = name.partition(_WIRE_SEP)
    return bare, (tp if parse_traceparent(tp) else None)


def wire_received(name, tp):
    """Record receipt of a stamped frame: an instant on the SENDER's
    context (tid/sid from the wire header, not this thread's stack), so
    the merged trace shows where each RPC landed."""
    if not enabled() or tp is None:
        return
    ctx = parse_traceparent(tp)
    if ctx is None:
        return
    rec = {"t": "inst", "name": "rpc.recv", "ts": int(time.time() * 1e6),
           "thr": threading.current_thread().name,
           "tid": ctx[0], "sid": ctx[1], "attrs": {"var": name}}
    _emit(rec)
