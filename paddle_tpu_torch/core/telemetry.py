"""Runtime telemetry of the port: one process-wide registry of counters,
gauges and histograms (with labels), a JSONL event stream, a time-series
ring for windowed rates, and the ``__metrics__`` RPC snapshot.

Counterpart of ``paddle_tpu/core/telemetry.py``, kept equal to it in
names, keys, label formatting, histogram buckets and JSON layout, so a
snapshot of either package merges with, and is scraped by, the other:

- gating: ``FLAGS_telemetry`` (off by default); every mutator returns at
  once when it is off, and nothing touches a file.  ``FLAGS_telemetry_dir``
  is where ``event`` streams ``steps.jsonl`` (rotated past
  ``FLAGS_telemetry_max_bytes``) and ``dump`` writes ``metrics.json`` and
  ``metrics.prom``;
- fleet merge: every histogram also counts into the fixed log-spaced
  bounds ``HIST_BUCKET_BOUNDS`` (the reference's ``_log_bounds``, copied),
  exported as cumulative ``buckets`` vectors, so replicas merge by
  elementwise sum (``merge_hist_snapshots``) and fleet percentiles come
  from ``bucket_percentile``;
- windowed rates: ``series_record`` (fed by the 1 s publisher) keeps a
  bounded ring of counter samples; ``series_rate`` and
  ``rate_from_samples`` turn deltas into reset-safe per-second rates;
- export: ``publish_rpc`` / ``start_publisher`` put the snapshot on an
  ``RpcServer`` of the port's transport under ``__metrics__``; ``scrape``
  GETs one from a server of either package.

``record_step`` is called by the executor once a ``run``.
"""

import atexit
import bisect
import json
import math
import os
import threading
import time

__all__ = [
    "enabled", "inc", "set_gauge", "observe", "event", "set_info",
    "record_step", "snapshot", "counter_total", "label_sets",
    "prometheus_text", "dump", "maybe_dump", "reset", "publish_rpc",
    "start_publisher", "decode_snapshot", "scrape", "METRICS_RPC_KEY",
    "HIST_BUCKET_BOUNDS", "bucket_percentile", "merge_hist_snapshots",
    "cumulative_to_deltas", "series", "series_record", "series_rate",
    "rate_from_samples",
]

METRICS_RPC_KEY = "__metrics__"

# histogram observations kept for percentile estimation; beyond the cap the
# sample set is decimated (every other kept) so long runs stay bounded
_HIST_SAMPLE_CAP = 8192
_EVENT_RING_CAP = 4096


def _log_bounds(lo, hi, growth):
    out, v = [], float(lo)
    while v < hi:
        out.append(round(v, 4))
        v *= growth
    out.append(float(hi))
    return tuple(out)


# Fixed log-spaced bucket upper bounds (ms), shared by EVERY histogram in
# every process: 0.05 ms .. 2 min at 1.25x growth (~67 buckets + overflow).
# Because the bounds are process-independent constants, bucket count
# vectors from different replicas merge by elementwise sum, and any
# consumer can recover a fleet-exact percentile to within one bucket
# width (<= 25% relative) from the merged cumulative counts — unlike the
# decimated sample lists, which cannot be merged.
HIST_BUCKET_BOUNDS = _log_bounds(0.05, 120000.0, 1.25)

_lock = threading.RLock()
_counters = {}     # (name, labels) -> float
_gauges = {}       # (name, labels) -> float
_hists = {}        # (name, labels) -> _Hist
_info = {}         # one-off structured payloads (set_info)
_events = []       # bounded in-memory ring of event dicts
_event_seq = {}    # kind -> next sequence number
_event_sink = [None, None]  # (path, open file handle) for the JSONL stream
_series = []       # bounded ring of timestamped counter/gauge samples


def _flags():
    from .. import flags

    return flags


def enabled():
    """One flag read — the profiler.is_profiler_enabled guard pattern."""
    return bool(_flags().flag("telemetry"))


def telemetry_dir():
    return _flags().flag("telemetry_dir") or ""


class _Hist:
    __slots__ = ("count", "sum", "min", "max", "samples", "buckets",
                 "_sorted")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples = []
        # per-bucket (non-cumulative) observation counts over the fixed
        # HIST_BUCKET_BOUNDS; last slot is the +Inf overflow bucket.
        # Never decimated — merges across replicas stay exact.
        self.buckets = [0] * (len(HIST_BUCKET_BOUNDS) + 1)
        self._sorted = None       # cached sorted view, invalidated on add

    def add(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.buckets[bisect.bisect_left(HIST_BUCKET_BOUNDS, v)] += 1
        self.samples.append(v)
        if len(self.samples) > _HIST_SAMPLE_CAP:
            del self.samples[::2]
        self._sorted = None

    def percentile(self, q):
        if not self.samples:
            return 0.0
        if self._sorted is None:
            self._sorted = sorted(self.samples)
        s = self._sorted
        i = min(int(q * len(s)), len(s) - 1)
        return s[i]

    def cumulative(self):
        """Prometheus-style cumulative bucket counts (last == count)."""
        out, run = [], 0
        for c in self.buckets:
            run += c
            out.append(run)
        return out

    def merge(self, other):
        """Fold another histogram in EXACTLY: counts, sums, and bucket
        vectors add; min/max fold.  Samples are appended (then decimated
        to the cap) so the local percentile estimate stays usable, but
        the bucket vector — the mergeable truth — is never decimated."""
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.samples.extend(other.samples)
        while len(self.samples) > _HIST_SAMPLE_CAP:
            del self.samples[::2]
        self._sorted = None
        return self


def bucket_percentile(cum_buckets, q, bounds=None):
    """Percentile from cumulative bucket counts: the upper bound of the
    bucket holding the rank-``q`` observation — within one bucket width
    of the true sample percentile, and exact across merges (bucket
    vectors sum where sample lists cannot)."""
    bounds = bounds or HIST_BUCKET_BOUNDS
    total = int(cum_buckets[-1]) if cum_buckets else 0
    if total <= 0:
        return 0.0
    # same rank convention as _Hist.percentile: s[min(int(q*n), n-1)]
    rank = min(int(q * total), total - 1) + 1
    for i, c in enumerate(cum_buckets):
        if c >= rank:
            return bounds[min(i, len(bounds) - 1)]
    return bounds[-1]


def cumulative_to_deltas(cum_buckets):
    """Cumulative bucket vector -> per-bucket counts (inverse of
    ``_Hist.cumulative``); deltas from different replicas sum directly."""
    out, prev = [], 0
    for c in cum_buckets:
        c = int(c)
        out.append(c - prev)
        prev = c
    return out


def merge_hist_snapshots(hists, bounds=None):
    """Merge per-replica histogram dump dicts (the ``snapshot()`` /
    ``scrape()`` shape) into one fleet-exact dict: count/sum/buckets
    sum, min/max fold, percentiles recomputed from the merged cumulative
    buckets.  Entries without bucket vectors (pre-merge snapshots)
    degrade to the conservative worst-replica percentile."""
    bounds = bounds or HIST_BUCKET_BOUNDS
    out = {"count": 0, "sum": 0.0, "min": float("inf"),
           "max": float("-inf")}
    merged = [0] * (len(bounds) + 1)
    have_buckets = True
    worst = {"p50": 0.0, "p90": 0.0, "p99": 0.0}
    for h in hists:
        if not h:
            continue
        out["count"] += int(h.get("count", 0))
        out["sum"] += float(h.get("sum", 0.0))
        if h.get("count"):
            out["min"] = min(out["min"], float(h.get("min", 0.0)))
            out["max"] = max(out["max"], float(h.get("max", 0.0)))
        for p in worst:
            worst[p] = max(worst[p], float(h.get(p, 0.0)))
        cum = h.get("buckets")
        if cum is None:
            have_buckets = False
        else:
            prev = 0
            for i, c in enumerate(cum[:len(merged)]):
                merged[i] += int(c) - prev
                prev = int(c)
    if out["count"] <= 0:
        out["min"] = out["max"] = 0.0
    if have_buckets:
        cum, run = [], 0
        for c in merged:
            run += c
            cum.append(run)
        out["buckets"] = cum
        for p, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            out[p] = bucket_percentile(cum, q, bounds)
    else:
        out.update(worst)
    return out


def _key(name, labels):
    return (name, tuple(sorted(labels.items())) if labels else ())


def _flat(name, labels):
    if not labels:
        return name
    return "%s{%s}" % (name, ",".join("%s=%s" % kv for kv in labels))


# -- mutators (no-ops when FLAGS_telemetry is off) ---------------------------

def inc(name, value=1, **labels):
    if not enabled():
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0) + value


def set_gauge(name, value, **labels):
    if not enabled():
        return
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def observe(name, value, **labels):
    if not enabled():
        return
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Hist()
        h.add(value)


def set_info(key, value):
    """Attach a one-off structured payload (folded into the JSON dump)."""
    if not enabled():
        return
    with _lock:
        _info[key] = value


def event(kind, **fields):
    """Append one structured event to the JSONL step log.  Events stream to
    ``<FLAGS_telemetry_dir>/steps.jsonl`` when a dir is set; a bounded
    in-memory ring keeps the tail either way."""
    if not enabled():
        return
    with _lock:
        seq = _event_seq.get(kind, 0)
        _event_seq[kind] = seq + 1
        rec = {"ev": kind, "seq": seq, "t": round(time.time(), 6)}
        rec.update(fields)
        _events.append(rec)
        if len(_events) > _EVENT_RING_CAP:
            del _events[: len(_events) - _EVENT_RING_CAP]
        d = telemetry_dir()
        if d:
            fh = _event_fh(d)
            if fh is not None:
                fh.write(json.dumps(rec) + "\n")
                fh.flush()


class _RotatingFile:
    """Append-only JSONL stream with size-bounded rotate-and-keep-one:
    when the file would exceed ``FLAGS_telemetry_max_bytes`` (or the
    explicit ``max_bytes``), it is renamed to ``<path>.1`` (replacing any
    previous generation) and writing restarts on a fresh file — long
    fleet soaks stay disk-bounded at ~2x the cap.  Shared by the
    steps.jsonl event stream."""

    __slots__ = ("path", "_fh", "_size", "_max")

    def __init__(self, path, max_bytes=None):
        self.path = path
        self._max = max_bytes
        self._fh = open(path, "a")
        self._size = self._fh.tell()

    def _limit(self):
        if self._max is not None:
            return int(self._max)
        v = _flags().flag("telemetry_max_bytes")
        return int(v) if v else 0

    def write(self, s):
        if self._fh is None:
            return
        limit = self._limit()
        if limit > 0 and self._size > 0 and self._size + len(s) > limit:
            try:
                self._fh.close()
                os.replace(self.path, self.path + ".1")
                self._fh = open(self.path, "a")
                self._size = 0
            except OSError:
                pass
        try:
            self._fh.write(s)
            self._size += len(s)
        except (OSError, ValueError):
            pass

    def flush(self):
        try:
            if self._fh is not None:
                self._fh.flush()
        except (OSError, ValueError):
            pass

    def close(self):
        try:
            if self._fh is not None:
                self._fh.close()
        except (OSError, ValueError):
            pass
        self._fh = None


def _event_fh(d):
    path = os.path.join(d, "steps.jsonl")
    if _event_sink[0] != path:
        if _event_sink[1] is not None:
            _event_sink[1].close()
        try:
            os.makedirs(d, exist_ok=True)
            _event_sink[0] = path
            _event_sink[1] = _RotatingFile(path)
        except OSError:
            _event_sink[0] = _event_sink[1] = None
    return _event_sink[1]


def record_step(wall_ms, cache_hit, compile_ms=None, donated=0,
                feed_bytes=0, fetch_bytes=0, carry_hits=0, carry_converts=0):
    """One executor step: bundle the counter/histogram updates plus the
    step event so the hot path pays a single enabled() check."""
    if not enabled():
        return
    inc("executor_steps_total")
    inc("executor_cache_hit_total" if cache_hit
        else "executor_cache_miss_total")
    observe("executor_step_ms", wall_ms)
    fields = {"wall_ms": round(wall_ms, 3), "cache_hit": bool(cache_hit)}
    if compile_ms is not None:
        observe("executor_compile_ms", compile_ms)
        fields["compile_ms"] = round(compile_ms, 3)
    if donated:
        inc("executor_donated_buffers_total", donated)
        fields["donated"] = donated
    if feed_bytes:
        inc("executor_feed_bytes_total", feed_bytes)
        fields["feed_bytes"] = feed_bytes
    if fetch_bytes:
        inc("executor_fetch_bytes_total", fetch_bytes)
        fields["fetch_bytes"] = fetch_bytes
    if carry_hits:
        inc("executor_carry_hit_total", carry_hits)
        fields["carry_hits"] = carry_hits
    if carry_converts:
        inc("executor_carry_convert_total", carry_converts)
        fields["carry_converts"] = carry_converts
    event("step", **fields)


# -- read side ---------------------------------------------------------------

def _finite(v):
    """inf/-inf/nan would emit non-standard JSON from dump() — clamp to
    0.0 (empty histograms carry +/-inf min/max sentinels)."""
    v = float(v)
    return round(v, 3) if math.isfinite(v) else 0.0


def snapshot():
    """Flat JSON-ready view: counters/gauges keyed ``name`` or
    ``name{k=v,...}``; histograms as count/sum/min/max/p50/p90/p99 plus
    the cumulative ``buckets`` vector over the shared
    ``bucket_bounds`` (top-level, emitted once) so any consumer can
    merge replicas exactly and recompute fleet percentiles."""
    with _lock:
        out = {
            "counters": {_flat(n, l): v for (n, l), v in _counters.items()},
            "gauges": {_flat(n, l): v for (n, l), v in _gauges.items()},
            "histograms": {
                _flat(n, l): {
                    "count": h.count,
                    "sum": _finite(h.sum),
                    "min": _finite(h.min) if h.count else 0.0,
                    "max": _finite(h.max) if h.count else 0.0,
                    "p50": _finite(h.percentile(0.50)),
                    "p90": _finite(h.percentile(0.90)),
                    "p99": _finite(h.percentile(0.99)),
                    "buckets": h.cumulative(),
                }
                for (n, l), h in _hists.items()
            },
            "events_logged": dict(_event_seq),
            "bucket_bounds": list(HIST_BUCKET_BOUNDS),
        }
        if _info:
            out["info"] = dict(_info)
        return out


def counter_total(name):
    """Sum of a counter across all label sets (0.0 when never touched)."""
    with _lock:
        return float(sum(v for (n, _), v in _counters.items() if n == name))


def label_sets(name, kind="counter"):
    """Every live label set of a counter/gauge family, as
    ``[(flat_key, {label: value}), ...]`` — consumers that window rates
    per label (per-tier shed/s, per-namespace hit/s) enumerate through
    this instead of re-parsing flat keys."""
    src = _counters if kind == "counter" else _gauges
    with _lock:
        return [(_flat(n, l), dict(l)) for (n, l) in src if n == name]


# -- time-series ring --------------------------------------------------------

def _series_cap():
    v = _flags().flag("telemetry_series_cap")
    return int(v) if v else 1024


def series_record(now=None):
    """Append one timestamped counter/gauge sample to the bounded
    in-process ring (the 1s publisher calls this every tick).  Windowed
    RATES — shed/s, tokens/s, cache-miss/s — fall out as counter deltas
    between ring samples instead of lifetime averages."""
    if not enabled():
        return None
    with _lock:
        rec = {"t": float(now if now is not None else time.time()),
               "counters": {_flat(n, l): float(v)
                            for (n, l), v in _counters.items()},
               "gauges": {_flat(n, l): v for (n, l), v in _gauges.items()}}
        _series.append(rec)
        cap = _series_cap()
        if len(_series) > cap:
            del _series[: len(_series) - cap]
        return rec


def series(window_s=None, now=None):
    """The ring's samples (oldest first), optionally only those within
    the trailing ``window_s`` seconds."""
    with _lock:
        if window_s is None:
            return list(_series)
        cut = float(now if now is not None else time.time()) - \
            float(window_s)
        return [s for s in _series if s["t"] >= cut]


def rate_from_samples(samples, window_s=None, now=None):
    """Reset-safe per-second rate from ``[(t, value), ...]`` counter
    samples: positive deltas between consecutive samples sum; a value
    DROP (replica restart zeroed the counter) contributes the post-reset
    value instead of a negative delta — the Prometheus ``rate()``
    counter-reset rule."""
    pts = [(float(t), float(v)) for t, v in samples]
    if window_s is not None:
        cut = float(now if now is not None else time.time()) - \
            float(window_s)
        inside = [i for i, (t, _) in enumerate(pts) if t >= cut]
        if len(inside) >= 2:
            pts = pts[inside[0]:]
        elif inside:
            # a single in-window sample has no delta — reach back to
            # one pre-cut sample as the baseline
            pts = pts[max(inside[0] - 1, 0):]
        else:
            pts = pts[-1:]
    if len(pts) < 2:
        return 0.0
    total = 0.0
    for (_, prev), (_, cur) in zip(pts, pts[1:]):
        d = cur - prev
        total += cur if d < 0 else d
    span = pts[-1][0] - pts[0][0]
    return total / span if span > 0 else 0.0


def series_rate(flat_name, window_s, now=None):
    """Windowed per-second rate of one flat counter key from the ring."""
    with _lock:
        pts = [(s["t"], s["counters"].get(flat_name, 0.0))
               for s in _series]
    return rate_from_samples(pts, window_s, now=now)


def prometheus_text(snap=None):
    """Prometheus exposition format: counters/gauges verbatim, histograms
    as summaries (quantile labels + _sum/_count)."""
    snap = snap if snap is not None else snapshot()

    def split(flat):
        if "{" in flat:
            name, rest = flat.split("{", 1)
            return name, rest.rstrip("}")
        return flat, ""

    def fmt(name, extra_labels, value):
        lbl = ",".join(x for x in extra_labels if x)
        return "%s%s %s" % (name, "{%s}" % lbl if lbl else "", value)

    lines = []
    for kind, d in (("counter", snap.get("counters", {})),
                    ("gauge", snap.get("gauges", {}))):
        seen = set()
        for flat in sorted(d):
            name, lbls = split(flat)
            if name not in seen:
                seen.add(name)
                lines.append("# TYPE %s %s" % (name, kind))
            labeled = ",".join('%s="%s"' % tuple(kv.split("=", 1))
                               for kv in lbls.split(",") if kv)
            lines.append(fmt(name, [labeled], d[flat]))
    seen = set()
    for flat in sorted(snap.get("histograms", {})):
        name, lbls = split(flat)
        h = snap["histograms"][flat]
        labeled = ",".join('%s="%s"' % tuple(kv.split("=", 1))
                           for kv in lbls.split(",") if kv)
        if name not in seen:
            seen.add(name)
            lines.append("# TYPE %s summary" % name)
        for q in ("0.5", "0.9", "0.99"):
            lines.append(fmt(name, [labeled, 'quantile="%s"' % q],
                             h["p" + q.replace("0.", "").ljust(2, "0")]))
        lines.append(fmt(name + "_sum", [labeled], h["sum"]))
        lines.append(fmt(name + "_count", [labeled], h["count"]))
    return "\n".join(lines) + "\n"


def dump(dirname=None):
    """Write metrics.json + metrics.prom under `dirname` (default:
    FLAGS_telemetry_dir).  Returns (json_path, prom_path)."""
    d = dirname or telemetry_dir()
    if not d:
        raise ValueError(
            "telemetry.dump() needs a directory (argument or "
            "FLAGS_telemetry_dir)")
    os.makedirs(d, exist_ok=True)
    snap = snapshot()
    jpath = os.path.join(d, "metrics.json")
    ppath = os.path.join(d, "metrics.prom")
    with open(jpath, "w") as f:
        json.dump(snap, f, indent=1, default=str)
    with open(ppath, "w") as f:
        f.write(prometheus_text(snap))
    return jpath, ppath


def maybe_dump():
    """dump() iff telemetry is on and a dir is configured — the end-of-run
    hook (atexit)."""
    if enabled() and telemetry_dir():
        try:
            dump()
        except OSError:
            pass


def reset():
    """Clear the registry and the event stream (tests)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _info.clear()
        _events.clear()
        _event_seq.clear()
        _series.clear()
        if _event_sink[1] is not None:
            _event_sink[1].close()
        _event_sink[0] = _event_sink[1] = None


# -- distributed scrape ------------------------------------------------------

def publish_rpc(server, key=METRICS_RPC_KEY):
    """Publish the current snapshot on an RpcServer's variable store so
    any RpcClient can GET it (the ``__metrics__`` RPC)."""
    if not enabled():
        return
    import numpy as np

    buf = json.dumps(snapshot(), default=str).encode("utf-8")
    server.set_var(key, np.frombuffer(buf, dtype=np.uint8).copy())


class PublisherHandle(threading.Event):
    """Stop handle for the publisher daemon: an Event (``set()`` alone
    keeps the legacy contract working) that also knows its thread, so
    shutdown can ``stop()`` — set AND join — instead of leaking the
    thread into the next test.  Idempotent: double-stop is a no-op."""

    def __init__(self):
        super(PublisherHandle, self).__init__()
        self.thread = None

    def stop(self, timeout=5.0):
        self.set()
        t = self.thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout)
        self.thread = None


def start_publisher(server, interval_s=1.0, key=METRICS_RPC_KEY,
                    stop_event=None, on_publish=None):
    """Republish the snapshot on `server` every `interval_s` so scrapes
    always read a fresh view (publish_rpc is one-shot).  Returns a
    PublisherHandle — call ``.stop()`` to end AND join the daemon thread
    (``.set()`` alone still ends it, legacy contract).  The serving
    frontend uses this for its __metrics__ endpoint.

    Every tick also appends a sample to the time-series ring
    (``series_record``) BEFORE publishing, so windowed rates are
    derivable on every replica for free; ``on_publish`` (optional) runs
    between the two — derived per-window gauges set there (per-tier
    shed/s, per-namespace hit rate) ride the same republish."""
    stop = PublisherHandle()

    def tick():
        series_record()
        if on_publish is not None:
            try:
                on_publish()
            except Exception:
                pass               # a derived gauge must never kill the
                                   # publisher
        publish_rpc(server, key=key)

    def loop():
        while not stop.wait(interval_s):
            if stop_event is not None and stop_event.is_set():
                return
            try:
                tick()
            except Exception:
                return  # server shut down under us

    tick()
    t = threading.Thread(target=loop, name="telemetry-publisher",
                         daemon=True)
    stop.thread = t
    t.start()
    return stop


def decode_snapshot(arr):
    """Inverse of publish_rpc's encoding (uint8 JSON bytes -> dict)."""
    import numpy as np

    return json.loads(np.asarray(arr, dtype=np.uint8).tobytes().decode(
        "utf-8"))


def scrape(endpoint, timeout=10.0, key=METRICS_RPC_KEY):
    """GET a live server's metrics snapshot.  Fails fast when the server
    runs with telemetry off (the key is never published, so the
    bounded-deadline GET errors)."""
    from ..native.rpc import RpcClient

    client = RpcClient(endpoint, connect_timeout=timeout,
                       rpc_deadline=timeout, retry_times=0)
    try:
        return decode_snapshot(client.get_var(key))
    finally:
        client.close()


atexit.register(maybe_dump)
