"""Named fault points for fault-injection testing.

A copy of ``paddle_tpu/utils/fault_injection.py``: the same spec syntax,
the same kinds, and for the same spec and seed the same firing sequence
(one ``random.Random`` drawn in the same order), so a chaos spec arms
either package alike.  The port's points: the RPC transport
(``rpc.send``, ``rpc.get``; ``native/rpc.py``), the checkpoint writer
(``ckpt.write``; ``io.py``), the wire server (``serving.infer``,
``serving.generate``, ``serving.reply``; ``serving/server.py``) and the
engines (``serving.execute.<model>``, ``serving.decode_step``;
``serving/engine.py``).  A point is just a name checked against the armed
spec, so callers may add their own.

Arming: set ``FLAGS_fault_spec`` (flag or env var) to a ``;``-separated list
of ``point:kind:prob[:count[:skip]]`` entries:

- ``point`` — fault-point name matched exactly against ``maybe_fail(point)``.
- ``kind``  — one of ``drop | delay | error | kill``.
- ``prob``  — firing probability per armed check (0..1].
- ``count`` — max number of firings (default: unlimited).
- ``skip``  — number of armed checks to let pass before the point may fire
  (default 0; makes ``kill`` deterministic mid-job instead of at step 0).

What a firing does is split between this module and the call site:

- ``delay`` — sleeps ~100 ms here, then the operation proceeds (slow link /
  slow server; exercises deadlines).
- ``kill``  — SIGKILLs the current process here (torn state on disk/in
  flight; exercises crash-safety + supervised relaunch).
- ``drop`` / ``error`` — returned to the caller as the fired kind; the call
  site maps them onto its own failure modes (rpc.py: ``drop`` = frame lost
  before transmission, ``error`` = transport failure after delivery).

Each firing counts ``fault_injected_total{point,kind}`` and leaves a
``note("fault", ...)`` in the flight recorder before it acts.
``maybe_fail`` costs one dict lookup when the spec is empty — fault points
are free in production.
"""

import os
import random

__all__ = ["maybe_fail", "FaultInjected", "arm", "disarm", "fault_stats"]

KINDS = ("drop", "delay", "error", "kill")

DELAY_SECONDS = 0.1


class FaultInjected(ConnectionError):
    """Raised by call sites for injected transport errors.  Subclasses
    ConnectionError so retry paths treat injected and real transport
    failures identically."""


class _Point:
    __slots__ = ("name", "kind", "prob", "count", "skip", "fired", "checked")

    def __init__(self, name, kind, prob, count, skip):
        self.name = name
        self.kind = kind
        self.prob = prob
        self.count = count      # None = unlimited firings
        self.skip = skip        # armed checks to let pass first
        self.fired = 0
        self.checked = 0


# armed points by name; _spec_src caches the parsed spec string so a flag
# change re-arms lazily without a hook into flags.set_flags
_points = {}
_spec_src = None
_rng = random.Random()


def _parse_spec(spec):
    points = {}
    for entry in (spec or "").replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 3:
            raise ValueError(
                "bad FLAGS_fault_spec entry %r (want point:kind:prob"
                "[:count[:skip]])" % entry)
        name, kind, prob = parts[0], parts[1], float(parts[2])
        if kind not in KINDS:
            raise ValueError("bad fault kind %r in %r (known: %s)"
                             % (kind, entry, "|".join(KINDS)))
        count = int(parts[3]) if len(parts) > 3 and parts[3] != "" else None
        skip = int(parts[4]) if len(parts) > 4 else 0
        points[name] = _Point(name, kind, prob, count, skip)
    return points


def _refresh():
    """Re-parse when the flag/env spec string changed."""
    global _points, _spec_src
    from .. import flags

    spec = flags.flag("fault_spec") or ""
    if spec != _spec_src:
        _spec_src = spec
        _points = _parse_spec(spec)


def arm(spec, seed=None):
    """Programmatically arm a spec string (in addition to, and overriding,
    FLAGS_fault_spec — same syntax).  seed makes prob<1 draws reproducible."""
    global _points, _spec_src
    _spec_src = None  # force re-read of the flag on next maybe_fail
    _points = _parse_spec(spec)
    if seed is not None:
        _rng.seed(seed)


def disarm():
    global _points, _spec_src
    _points = {}
    _spec_src = ""


def fault_stats():
    """point name -> (checked, fired) counters for armed points."""
    return {p.name: (p.checked, p.fired) for p in _points.values()}


def maybe_fail(point):
    """Check the named fault point.  Returns None (no fault), or the fired
    kind ``"drop"``/``"error"`` for the call site to act on.  ``delay``
    sleeps here and returns None; ``kill`` does not return."""
    if not _points:
        if _spec_src is None or _spec_src == "":
            # unarmed fast path — but a spec may have been set via flags
            # since the last check
            _refresh()
            if not _points:
                return None
        else:
            return None
    p = _points.get(point)
    if p is None:
        return None
    p.checked += 1
    if p.checked <= p.skip:
        return None
    if p.count is not None and p.fired >= p.count:
        return None
    if p.prob < 1.0 and _rng.random() >= p.prob:
        return None
    p.fired += 1
    # telemetry BEFORE the fault acts: a "kill" never returns, and the
    # post-mortem registry (pserver __metrics__ scrape / relaunch logs)
    # should still attribute the crash to the injected point
    from ..core import telemetry as _tm

    _tm.inc("fault_injected_total", point=p.name, kind=p.kind)
    # flight-recorder dump BEFORE the fault acts, same reasoning: the
    # note() write-through puts the postmortem on disk even for "kill"
    try:
        from ..core import tracing as _tracing

        _tracing.note("fault", point=p.name, fault_kind=p.kind)
    except Exception:
        pass
    if p.kind == "delay":
        import time

        time.sleep(DELAY_SECONDS * (0.5 + _rng.random()))
        return None
    if p.kind == "kill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)
    return p.kind  # "drop" | "error"
