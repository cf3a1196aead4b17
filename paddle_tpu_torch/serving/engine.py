"""Serving engines of the port: ``DecodeEngine`` (autoregressive decode,
paged KV cache + token-level batching) and ``ServingEngine`` (batched
inference over AnalysisPredictor, at the end of this module).

``DecodeEngine`` is the counterpart of the non-speculative f32 path of
``DecodeEngine`` in ``paddle_tpu/serving/engine.py``.  Every iteration of
the decode loop:

1. times out queued sequences whose deadline passed, then admits waiting
   sequences into free lanes while the pool can hold their prompts (in
   ``request`` mode only when no lane is active — the static-batching
   baseline);
2. drops aborted and deadline-expired active sequences, picks the lanes
   that run this step (all of them, or decode lanes plus prefill lanes
   up to the prefill token budget), grows their block tables, and pads
   them to the smallest lane bucket that fits — idle lanes point at the
   scratch block 0 with context length 0;
3. runs ONE ``Decoder.paged_step`` on the device: prompts are fed one
   token per step through the same step as generation;
4. appends each live lane's token, finishing sequences at max_new/EOS
   and freeing their blocks in the SAME iteration, so the next
   admission sees the space.

A mid-decode allocation failure preempts the youngest other active
sequence (blocks freed, re-queued at the front; greedy decode is
deterministic, so its replay re-feeds prompt ++ emitted tokens and
emission resumes at the next new index).  Admission that the pool cannot
cover sheds with ``retry_after_ms``.  Prefix caching (on by default)
seeds a new sequence's table with shared, refcounted blocks of an
earlier identical prompt prefix and jumps its feed pointer past them.

Both engines emit the reference's serving metrics into the port's
telemetry registry (``core/telemetry.py``, inert unless
``FLAGS_telemetry``), under the reference's names, labels and buckets,
and call ``on_batch_boundary`` (the fleet's eviction hook) between
batches and between decode steps, never while ``in_batch`` is true.
``DecodeEngine.prewarm`` runs one step per lane bucket.

Both engines trace as the reference does (``core/tracing.py``, inert
unless ``FLAGS_tracing``): an admitted request opens ``serving.request``
(under the server's admission span when submitted inside it) with a
``serving.queue_wait`` child ended at admission to a lane or dispatch; a
decode step is a ``serving.decode_step`` span linking each lane's request
span, an encoder batch a ``serving.batch`` span linking its requests, with
``serving.pad_to_bucket`` and ``serving.execute`` (the Executor's
``executor.step`` nests under it) as children.  Before the device work
starts, a write-through ``note`` (``decode_step`` or ``batch_start``)
names the request ids, so a SIGKILLed replica's
``flightrec-<pid>.json`` holds its in-flight work.  Fault points
(``utils/fault_injection.py``): ``serving.decode_step``, checked outside
the lock before each decode iteration that has work, and
``serving.execute.<model>``, checked before a batch runs ("error" fails
the batch).

Left out of the decode engine, compared with the reference: speculative
decode, int8 KV, disaggregated handoff, session migration and history
publication, and tier weights and tier eviction (every decode request is
tier "default").
"""

import collections
import logging
import threading
import time
import uuid
import zlib

import numpy as np
import torch

from ..core import telemetry as _tm
from ..core import tracing as _tr
from ..device import resolve_device, set_f32_numerics
from ..utils.fault_injection import maybe_fail
from . import decode_model as _dm
from . import kv_cache as _kvc

__all__ = ["DecodeEngine", "ServingEngine", "InferReply", "parse_buckets",
           "parse_tier_weights", "tier_weight"]

_log = logging.getLogger(__name__)

_QPS_WINDOW_S = 5.0         # trailing window of the serving_qps gauge
_DEFAULT_TIER = "default"   # the tier label of every decode request


def parse_buckets(spec):
    """\"1,4,16\" (or an int sequence) -> sorted unique bucket tuple."""
    if isinstance(spec, str):
        sizes = [int(s) for s in spec.replace(" ", "").split(",") if s]
    else:
        sizes = [int(s) for s in spec]
    if not sizes or any(s <= 0 for s in sizes):
        raise ValueError("serving buckets must be positive ints: %r" % spec)
    return tuple(sorted(set(sizes)))


class InferReply:
    """Terminal state of one request: status ok|shed|timeout|error|
    aborted."""

    __slots__ = ("status", "outputs", "error", "retry_after_ms",
                 "latency_ms", "phases")

    def __init__(self, status, outputs=None, error=None,
                 retry_after_ms=0.0, latency_ms=0.0, phases=None):
        self.status = status
        self.outputs = outputs or {}
        self.error = error
        self.retry_after_ms = float(retry_after_ms)
        self.latency_ms = float(latency_ms)
        self.phases = phases or {}

    @property
    def ok(self):
        return self.status == "ok"

    def to_meta(self):
        """The reply's JSON-able meta as the wire carries it (the outputs'
        names in order; their arrays travel beside it)."""
        meta = {"status": self.status, "error": self.error,
                "retry_after_ms": round(self.retry_after_ms, 3),
                "latency_ms": round(self.latency_ms, 3),
                "outputs": list(self.outputs)}
        if self.phases:
            meta["phases"] = self.phases
        return meta


class _Pending:
    """Handle returned by submit(): wait() blocks for the InferReply."""

    __slots__ = ("model", "deadline", "t_submit", "req_id", "callback",
                 "_done", "reply", "traceparent", "span", "qspan")

    def __init__(self, model, deadline_ms, req_id, callback,
                 traceparent=None):
        self.model = model
        self.t_submit = time.perf_counter()
        self.deadline = self.t_submit + deadline_ms / 1e3
        self.req_id = req_id
        self.callback = callback
        self._done = threading.Event()
        self.reply = None
        self.traceparent = traceparent  # wire context echoed in the reply
        self.span = None    # serving.request (submit -> complete)
        self.qspan = None   # serving.queue_wait (submit -> admission)

    def complete(self, reply):
        reply.latency_ms = (time.perf_counter() - self.t_submit) * 1e3
        self.reply = reply
        self._done.set()
        if self.callback is not None:
            try:
                self.callback(self)
            except Exception:  # a client callback never stops the loop
                _log.exception("request callback failed")

    def wait(self, timeout=None):
        self._done.wait(timeout)
        return self.reply


class _DecodeSeq:
    """One sequence moving through the scheduler.  ``n_fed`` counts
    positions already written to the KV cache; positions below
    ``replay_upto`` are fed from known history (prompt ++ out) with the
    step's output discarded, so a preempted sequence never re-emits."""

    __slots__ = ("pending", "prompt", "max_new", "eos_id", "on_token",
                 "blocks", "table", "n_fed", "next_tok", "out", "t_admit",
                 "t_first", "token_times", "admit_seq", "aborted", "hashes",
                 "published", "cached_tokens", "replay_upto")

    def __init__(self, pending, prompt, max_new, eos_id, on_token, maxb):
        self.pending = pending
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = int(eos_id)
        self.on_token = on_token
        self.blocks = []                      # allocator block ids held
        self.table = np.full(maxb, -1, np.int32)
        self.n_fed = 0
        self.next_tok = self.prompt[0]
        self.out = []
        self.t_admit = None
        self.t_first = None                   # first generated token
        self.token_times = []
        self.admit_seq = 0                    # preemption picks max()
        self.aborted = False
        self.hashes = None                    # full-prompt hash chain
        self.published = 0                    # leading blocks indexed
        self.cached_tokens = 0
        self.replay_upto = len(self.prompt)

    @property
    def in_prefill(self):
        return self.n_fed < self.replay_upto

    def feed_tok(self, i):
        p = len(self.prompt)
        return self.prompt[i] if i < p else self.out[i - p]

    def reset_for_recompute(self):
        """Preempted: blocks were freed; replay prompt ++ out from the
        start (or from a prefix-cache hit) with outputs discarded."""
        self.blocks = []
        self.table.fill(-1)
        self.n_fed = 0
        self.next_tok = self.prompt[0]
        self.replay_upto = len(self.prompt) + len(self.out)
        self.t_first = None
        self.token_times = []
        self.hashes = None
        self.published = 0
        self.cached_tokens = 0


class _DecodeModel:
    __slots__ = ("name", "cfg", "decoder", "kv_config", "cache", "maxb",
                 "step_ms", "step_ms_samples", "prefix", "warmed")

    def __init__(self, name, cfg, decoder, kv_config, cache, prefix):
        self.name = name
        self.cfg = cfg
        self.decoder = decoder
        self.kv_config = kv_config
        self.cache = cache
        self.maxb = -(-cfg.max_seq // kv_config.block_size)
        self.step_ms = 0.0              # EWMA of one decode step
        self.step_ms_samples = collections.deque(maxlen=4096)
        self.prefix = prefix
        self.warmed = set()             # lane buckets prewarm has run


class DecodeEngine:
    """Token-level continuous batching over an engine-owned paged KV
    cache, on ``device`` (default ``cuda``; the CPU only when asked).

    The defaults are the reference's decode flag defaults: lane buckets
    "4,8", block size 16, "token" mode, prefix cache on, no prefill
    token budget, a queue of 256 and a 2000 ms deadline."""

    def __init__(self, buckets="4,8", max_queue=256, deadline_ms=2000.0,
                 mode="token", block_size=16, prefix_cache=True,
                 prefill_token_budget=0, device=None):
        self.device = resolve_device(device)
        set_f32_numerics()
        self.buckets = parse_buckets(buckets)
        self.max_queue = int(max_queue)
        self.default_deadline_ms = float(deadline_ms)
        if mode not in ("token", "request"):
            raise ValueError("decode mode must be token|request, got %r"
                             % (mode,))
        self.mode = mode
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self.prefill_token_budget = int(prefill_token_budget)
        self._draining = False
        self._models = {}
        self._waiting = []          # FIFO of _DecodeSeq
        self._active = []
        self._cond = threading.Condition()
        self._running = False
        self._thread = None
        self._admit_seq = 0
        self._step_no = 0
        self._rr_prefill = 0        # round-robin pointer (token budget)
        self.preemptions = 0
        # true while a decode step runs on the device; the fleet publishes
        # a membership change only when it is false
        self.in_batch = False
        # called with the lock released after every decode step (the
        # fleet's tick), so a view change lands between steps
        self.on_batch_boundary = None

    @property
    def steps(self):
        """Decode steps run so far (each is one paged_step call)."""
        return self._step_no

    # -- registry ------------------------------------------------------------

    def add_model(self, name, source, kv_blocks=None):
        """Register a decode model: ``source`` is a save_decoder()
        directory of either package or a (DecoderConfig, numpy params)
        pair.  ``kv_blocks`` sizes the KV pool (default 64)."""
        if isinstance(source, str):
            cfg, params = _dm.load_decoder(source)
        else:
            cfg, params = source
        kv_config = _kvc.KVCacheConfig(
            layers=cfg.layers, heads=cfg.heads, head_dim=cfg.head_dim,
            block_size=self.block_size, num_blocks=2)
        kv_config.num_blocks = _kvc.plan_num_blocks(
            kv_config, requested=kv_blocks)[0]
        cache = _kvc.PagedKVCache(kv_config, device=self.device)
        prefix = _kvc.PrefixCache(cache.allocator, self.block_size,
                                  namespace=name) \
            if self.prefix_cache else None
        decoder = _dm.Decoder(cfg, params, device=self.device)
        self._models[name] = _DecodeModel(name, cfg, decoder, kv_config,
                                          cache, prefix)
        return self._models[name]

    def models(self):
        return list(self._models)

    def spec(self, model):
        """JSON-able description of ``model`` (the reference's keys; the
        port's KV pool is f32 and it has no speculative decode)."""
        m = self._models[model]
        return {"model": model, "type": "decode",
                "vocab": m.cfg.vocab, "max_seq": m.cfg.max_seq,
                "buckets": list(self.buckets), "mode": self.mode,
                "block_size": m.kv_config.block_size,
                "num_blocks": m.kv_config.num_blocks,
                "kv_dtype": "f32", "speculative_k": 0,
                "prefix_cache": m.prefix is not None}

    # -- prewarm -------------------------------------------------------------

    def prewarm(self):
        """One decode step per (model, lane bucket) before any request:
        every lane feeds token 0 at position 0 through the scratch block 0
        (context length 1), so the step's kernels and libraries are loaded
        and run at each bucket's shape.  Returns the manifest {model:
        {bucket: {"source", "compile_ms"}}}: "compiled" the first time a
        (model, bucket) runs, "memory" after, and the step's wall ms."""
        manifest = {}
        for name, m in self._models.items():
            per = {}
            for b in self.buckets:
                source = "memory" if b in m.warmed else "compiled"
                dev = self.device
                t0 = time.perf_counter()
                nxt, _logits = m.decoder.paged_step(
                    m.cache.k, m.cache.v,
                    torch.zeros(b, dtype=torch.int32, device=dev),
                    torch.zeros(b, dtype=torch.int32, device=dev),
                    torch.full((b, m.maxb), -1, dtype=torch.int32,
                               device=dev),
                    torch.ones(b, dtype=torch.int32, device=dev))
                nxt.cpu()                   # waits for the device
                ms = (time.perf_counter() - t0) * 1e3
                m.warmed.add(b)
                per[b] = {"source": source, "compile_ms": round(ms, 3)}
                _tm.inc("serving_prewarm_total", model=name, source=source)
                _tm.event("serving_prewarm", model=name, bucket=b,
                          source=source, decode=True, ms=round(ms, 3))
            manifest[name] = per
        return manifest

    # -- admission -----------------------------------------------------------

    def _retry_after_ms(self, m):
        """Time for roughly one block's worth of tokens to drain."""
        per = m.step_ms if m.step_ms > 0 else 1.0
        return max(per * m.kv_config.block_size, 1.0)

    @staticmethod
    def _count_shed(reason):
        _tm.inc("serving_shed_total", reason=reason)
        _tm.inc("serving_tier_shed_total", tier=_DEFAULT_TIER)

    def submit(self, model, prompt_ids, max_new_tokens=16, deadline_ms=None,
               eos_id=-1, callback=None, on_token=None, req_id=None,
               tenant="default", traceparent=None):
        """Enqueue one request; returns a _Pending whose reply carries
        outputs={"tokens"} plus queue/TTFT/ITL phases.
        ``on_token(req_id, index, token, done, status)`` fires per
        generated token; on a non-ok end it fires once with token None.
        ``tenant`` labels the request counter only; ``traceparent`` (the
        wire context) is echoed in the reply meta."""
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        req = _Pending(model, deadline_ms, req_id or uuid.uuid4().hex,
                       callback, traceparent=traceparent)

        def _early(reply):
            req.complete(reply)
            if on_token is not None:
                try:
                    on_token(req.req_id, 0, None, True, reply.status)
                except Exception:  # a client callback never stops submit
                    _log.exception("on_token callback failed")
            return req

        m = self._models.get(model)
        if m is None or not self._running:
            return _early(InferReply(
                "error", error="unknown decode model %r" % model
                if m is None else "decode engine not running"))
        if not prompt_ids:
            return _early(InferReply("error", error="empty prompt"))
        total = len(prompt_ids) + int(max_new_tokens)
        if total > m.cfg.max_seq:
            return _early(InferReply(
                "error", error="prompt+max_new %d exceeds max_seq %d"
                % (total, m.cfg.max_seq)))
        if any(t < 0 or t >= m.cfg.vocab for t in prompt_ids):
            return _early(InferReply("error", error="token out of vocab"))
        need_cap = m.cache.blocks_for_tokens(total)
        if need_cap > m.cache.allocator.capacity:
            return _early(InferReply(
                "error", error="sequence needs %d KV blocks, pool holds %d"
                % (need_cap, m.cache.allocator.capacity)))
        _tm.inc("serving_decode_requests_total", model=model, tenant=tenant)
        seq = _DecodeSeq(req, prompt_ids, max_new_tokens, eos_id, on_token,
                         m.maxb)
        with self._cond:
            if self._draining:
                self._count_shed("draining")
                return _early(InferReply(
                    "shed", error="replica draining",
                    retry_after_ms=self._retry_after_ms(m)))
            if len(self._waiting) >= self.max_queue:
                self._count_shed("queue_full")
                return _early(InferReply(
                    "shed", error="queue full (%d)" % len(self._waiting),
                    retry_after_ms=self._retry_after_ms(m)))
            # KV pressure: blocks promised to the queue ahead plus this
            # prompt must fit the reclaimable pool (free + zero-ref
            # cached blocks), else shed with a drain-time hint
            promised = sum(m.cache.blocks_for_tokens(s.replay_upto)
                           for s in self._waiting
                           if s.pending.model == model)
            need_now = promised + m.cache.blocks_for_tokens(seq.replay_upto)
            free_now = m.cache.allocator.reclaimable
            if need_now > free_now:
                self._count_shed("kv_oom")
                return _early(InferReply(
                    "shed", error="KV pool exhausted (%d reclaimable "
                    "blocks)" % free_now,
                    retry_after_ms=self._retry_after_ms(m)))
            req.span = _tr.start_span(
                "serving.request", model=model, tenant=tenant,
                decode=True, prompt_tokens=len(prompt_ids),
                max_new=int(max_new_tokens), req_id=req.req_id)
            req.qspan = _tr.start_span("serving.queue_wait",
                                       parent=req.span,
                                       depth=len(self._waiting))
            self._waiting.append(seq)
            _tm.set_gauge("serving_queue_depth", len(self._waiting))
            self._cond.notify_all()
        return req

    def generate(self, model, prompt_ids, max_new_tokens=16, **kw):
        """Synchronous submit + wait."""
        deadline_ms = float(kw.get("deadline_ms")
                            or self.default_deadline_ms)
        req = self.submit(model, prompt_ids, max_new_tokens=max_new_tokens,
                          **kw)
        reply = req.wait(timeout=deadline_ms / 1e3 + 30.0)
        return reply if reply is not None else InferReply(
            "timeout", error="no reply within deadline")

    def abort(self, req_id):
        """Drop a sequence by request id; True when a waiting or active
        sequence was found."""
        with self._cond:
            for i, s in enumerate(self._waiting):
                if s.pending.req_id == req_id:
                    self._waiting.pop(i)
                    _tm.set_gauge("serving_queue_depth", len(self._waiting))
                    self._finish(s, InferReply("aborted",
                                               error="aborted by client"))
                    _tm.inc("serving_abort_total", phase="queued")
                    return True
            for s in self._active:
                if s.pending.req_id == req_id and not s.aborted:
                    s.aborted = True   # freed at the next step boundary
                    _tm.inc("serving_abort_total",
                            phase="prefill" if s.in_prefill else "decode")
                    return True
        return False

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._decode_loop,
                                        name="serving-decode", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_s=5.0):
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(drain_s)
            self._thread = None
        with self._cond:
            leftovers = self._active + self._waiting
            self._active, self._waiting = [], []
        for s in leftovers:
            self._free_blocks(s)
            self._finish(s, InferReply("error", error="engine stopped"))

    def drain(self, timeout_s=30.0):
        """Shed new arrivals and wait for every waiting and active
        sequence to finish; True when the engine emptied in time."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            with self._cond:
                if not self._waiting and not self._active:
                    return True
            time.sleep(0.01)
        return False

    # -- scheduling ----------------------------------------------------------

    def _model_of(self, seq):
        return self._models[seq.pending.model]

    def _free_blocks(self, seq):
        if seq.blocks:
            self._model_of(seq).cache.allocator.free(seq.blocks)
            seq.blocks = []
            seq.table.fill(-1)

    def _finish(self, seq, reply):
        r = seq.pending
        if reply.ok or reply.status == "timeout":
            now = time.perf_counter()
            phases = {"queue_wait_ms": round(
                ((seq.t_admit or now) - r.t_submit) * 1e3, 3),
                "tokens": len(seq.out),
                "prompt_tokens": len(seq.prompt),
                "cached_tokens": seq.cached_tokens, "model": r.model}
            if seq.t_first is not None:
                phases["ttft_ms"] = round((seq.t_first - r.t_submit) * 1e3, 3)
            if len(seq.token_times) > 1:
                phases["itl_ms_samples"] = [
                    round((b - a) * 1e3, 3) for a, b in
                    zip(seq.token_times, seq.token_times[1:])]
            reply.phases = phases
        if reply.ok:
            reply.outputs = {"tokens": np.asarray(seq.out, np.int32)}
        r.complete(reply)
        if reply.ok:
            # the fleet-mergeable histograms and the goodput counters
            _tm.observe("server_ms", reply.latency_ms, tier=_DEFAULT_TIER)
            if "ttft_ms" in reply.phases:
                _tm.observe("ttft_ms", reply.phases["ttft_ms"],
                            model=r.model)
            for g in reply.phases.get("itl_ms_samples") or ():
                _tm.observe("itl_ms", g, model=r.model)
            met = time.perf_counter() <= r.deadline
            _tm.inc("serving_deadline_met_total" if met
                    else "serving_deadline_missed_total", tier=_DEFAULT_TIER)
            if met:
                _tm.inc("serving_deadline_tokens_total", len(seq.out),
                        tier=_DEFAULT_TIER)
        if r.qspan is not None:
            r.qspan.end()
            r.qspan = None
        if r.span is not None:
            r.span.annotate(status=reply.status, tokens=len(seq.out)).end()
            r.span = None
        if seq.on_token is not None and not reply.ok:
            # terminal stream chunk so a streaming client unblocks
            try:
                seq.on_token(r.req_id, len(seq.out), None, True,
                             reply.status)
            except Exception:  # a client callback never stops the loop
                _log.exception("request callback failed")

    def _expire_and_admit(self):
        """Under the lock: time out stale waiters, then admit while
        lanes and blocks allow."""
        now = time.perf_counter()
        keep = []
        for s in self._waiting:
            if now > s.pending.deadline:
                _tm.inc("serving_timeout_total", model=s.pending.model)
                self._finish(s, InferReply(
                    "timeout", error="deadline expired in queue"))
            else:
                keep.append(s)
        self._waiting[:] = keep
        max_lanes = max(self.buckets)
        while self._waiting and len(self._active) < max_lanes:
            if self.mode == "request" and self._active:
                break  # request-level baseline: no mid-flight joins
            s = self._waiting[0]
            m = self._model_of(s)
            if self._active and \
                    self._active[0].pending.model != s.pending.model:
                break  # one model per step batch
            if m.cache.blocks_for_tokens(s.replay_upto) > \
                    m.cache.allocator.reclaimable:
                break  # head of line waits for blocks to free
            self._waiting.pop(0)
            self._admit_seq += 1
            s.admit_seq = self._admit_seq
            s.t_admit = now
            if m.prefix is not None:
                # longest-prefix match, capped at len(prompt) - 1 tokens:
                # shared blocks seed the table and the feed pointer jumps
                # past them, so every write lands in a private tail block
                shared, cached, hashes = m.prefix.match(s.prompt)
                s.hashes = hashes
                s.published = len(shared)
                s.cached_tokens = cached
                if cached:
                    s.blocks = list(shared)
                    s.table[:len(shared)] = shared
                    s.n_fed = cached
                    s.next_tok = s.feed_tok(cached)
            if s.pending.span is not None:
                s.pending.span.annotate(cached_tokens=s.cached_tokens)
            if s.pending.qspan is not None:
                s.pending.qspan.end()
                s.pending.qspan = None
            self._active.append(s)
        _tm.set_gauge("serving_queue_depth", len(self._waiting))
        for name, m in self._models.items():
            alloc = m.cache.allocator
            cap = float(alloc.capacity) or 1.0
            _tm.set_gauge("kv_pool_occupancy", alloc.in_use / cap,
                          model=name)
            _tm.set_gauge("kv_pool_reclaimable_ratio",
                          alloc.reclaimable / cap, model=name)
            if m.prefix is not None:
                _tm.set_gauge("prefix_cache_hit_rate", m.prefix.hit_rate(),
                              model=name)

    def _ensure_block(self, seq):
        """Cover seq's next write position, preempting the youngest
        other active sequence on pool exhaustion.  False means seq
        itself was completed with an error (no victim was left)."""
        m = self._model_of(seq)
        while True:
            if m.cache.ensure_table(seq.table, seq.blocks, seq.n_fed + 1):
                return True
            victims = [s for s in self._active if s is not seq]
            if not victims:
                self._active.remove(seq)
                self._free_blocks(seq)
                self._finish(seq, InferReply(
                    "error", error="KV pool exhausted with no victim"))
                return False
            v = max(victims, key=lambda s: s.admit_seq)
            self._active.remove(v)
            self._free_blocks(v)
            v.reset_for_recompute()
            self._waiting.insert(0, v)
            self.preemptions += 1
            _tm.inc("kv_block_evictions_total", model=v.pending.model)
            _tm.event("decode_preempt", victim=v.pending.req_id,
                      for_req=seq.pending.req_id)

    def _publish_prefix_locked(self, m, s):
        """Publish every newly completed FULL prompt block of ``s``
        (first-publisher-wins).  Only blocks whose every position holds
        a prompt token are eligible, so a mid-prefill abort can never
        publish a partial block."""
        if m.prefix is None or s.hashes is None:
            return
        done = min(s.n_fed, len(s.prompt)) // m.kv_config.block_size
        while s.published < min(done, len(s.hashes)):
            j = s.published
            m.prefix.publish(s.blocks[j], s.hashes[j])
            s.published = j + 1

    def _plan_lanes_locked(self):
        """Lanes that run this step.  Without a prefill token budget,
        every active lane (up to the largest bucket).  With a budget B,
        decode lanes always run and prefilling lanes join round-robin
        until B prefill tokens (one each per step) are spent."""
        max_lanes = max(self.buckets)
        budget = self.prefill_token_budget
        if budget <= 0:
            return self._active[:max_lanes]
        decode = [s for s in self._active if not s.in_prefill]
        prefill = [s for s in self._active if s.in_prefill]
        if prefill:
            r = self._rr_prefill % len(prefill)
            prefill = prefill[r:] + prefill[:r]
        chosen = prefill[:max(0, min(budget, max_lanes - len(decode)))]
        self._rr_prefill += max(len(chosen), 1)
        return (decode + chosen)[:max_lanes]

    def _bucket_for(self, lanes):
        for b in self.buckets:
            if lanes <= b:
                return b
        return max(self.buckets)

    def _decode_loop(self):
        while True:
            # outside the lock, so a "delay" slows the loop without
            # holding submitters; checked once before every step and never
            # on an idle poll, so a spec's skip counts decode steps
            checked = bool(self._active or self._waiting)
            if checked:
                maybe_fail("serving.decode_step")
            with self._cond:
                if not self._running:
                    return
                self._expire_and_admit()
                if not self._active:
                    self._cond.wait(0.05)
                    continue
                if not checked:
                    continue    # work arrived after the check: check it
                step_ok = self._decode_step_locked()
            if self.on_batch_boundary is not None:
                try:
                    self.on_batch_boundary()
                except Exception:  # the hook never stops the loop
                    _log.exception("on_batch_boundary failed")
            if not step_ok:
                time.sleep(0.001)

    def _decode_step_locked(self):
        """One token for every participating lane (self._cond held).
        Sequences join and leave only at iteration boundaries.  The lock
        is released around the device step itself: other threads only
        append to the queue (submit), unlink a queued sequence or flag an
        active one (abort), or read the lists (drain), while lane state,
        admission, the allocator's blocks and the KV pools are touched by
        this thread alone.  Held across the step, the lock would starve
        submitters, since a released lock is not handed to its waiter."""
        m = self._model_of(self._active[0])
        now = time.perf_counter()
        for s in list(self._active):
            if s.aborted:
                self._active.remove(s)
                self._free_blocks(s)
                self._finish(s, InferReply("aborted",
                                           error="aborted by client"))
            elif now > s.pending.deadline:
                self._active.remove(s)
                self._free_blocks(s)
                _tm.inc("serving_timeout_total", model=s.pending.model)
                self._finish(s, InferReply(
                    "timeout", error="deadline expired mid-decode"))
        if not self._active:
            return True
        participants = self._plan_lanes_locked()
        for s in participants:
            if s in self._active:
                self._ensure_block(s)  # may preempt or complete a lane
        lanes = [s for s in participants if s in self._active]
        if not lanes:
            return True
        bucket = self._bucket_for(len(lanes))
        tok = np.zeros(bucket, np.int32)
        pos = np.zeros(bucket, np.int32)
        tables = np.full((bucket, m.maxb), -1, np.int32)
        lens = np.zeros(bucket, np.int32)
        for i, s in enumerate(lanes):
            tok[i] = s.next_tok
            pos[i] = s.n_fed
            tables[i] = s.table
            lens[i] = s.n_fed + 1    # counts this step's write
        self._step_no += 1
        sspan = _tr.start_span(
            "serving.decode_step", model=m.name, bucket=bucket,
            lanes=len(lanes), step=self._step_no)
        for s in lanes:
            sspan.link(s.pending.span.context
                       if s.pending.span is not None else None)
        # write-through, before the device step: a SIGKILL mid-step
        # leaves these request ids in flightrec-<pid>.json
        _tr.note("decode_step", model=m.name, step=self._step_no,
                 req_ids=[s.pending.req_id for s in lanes])
        t0 = time.perf_counter()
        err = None
        self.in_batch = True
        self._cond.release()
        try:
            dev = self.device
            with _tr.activate(sspan):
                nxt, _logits = m.decoder.paged_step(
                    m.cache.k, m.cache.v, torch.from_numpy(tok).to(dev),
                    torch.from_numpy(pos).to(dev),
                    torch.from_numpy(tables).to(dev),
                    torch.from_numpy(lens).to(dev))
                nxt = nxt.cpu().numpy()
        except Exception as e:  # the loop keeps serving; the lanes fail
            _log.exception("decode step failed on %d lanes", len(lanes))
            err = e
        finally:
            self._cond.acquire()
            self.in_batch = False
        if not self._running:
            sspan.annotate(stopped=True).end()
            return True     # stopping: stop() finishes every sequence
        if err is not None:
            for s in lanes:
                self._active.remove(s)
                self._free_blocks(s)
                self._finish(s, InferReply(
                    "error", error="%s: %s" % (type(err).__name__, err)))
            _tm.inc("serving_batch_errors_total", model=m.name)
            sspan.annotate(error=str(err)[:200]).end()
            return False
        ms = (time.perf_counter() - t0) * 1e3
        m.step_ms = ms if m.step_ms <= 0 else 0.8 * m.step_ms + 0.2 * ms
        m.step_ms_samples.append(ms)
        t_tok = time.perf_counter()
        n_generated = 0
        for i, s in enumerate(lanes):
            s.n_fed += 1
            # seal + publish any prompt block this write completed
            self._publish_prefix_locked(m, s)
            if s.in_prefill:
                s.next_tok = s.feed_tok(s.n_fed)
                continue
            token = int(nxt[i])
            s.next_tok = token
            s.out.append(token)
            s.token_times.append(t_tok)
            if s.t_first is None:
                s.t_first = t_tok
            n_generated += 1
            done = len(s.out) >= s.max_new or token == s.eos_id
            if s.on_token is not None:
                try:
                    s.on_token(s.pending.req_id, len(s.out) - 1, token,
                               done, "ok")
                except Exception:  # a client callback never stops the loop
                    _log.exception("on_token callback failed")
            if done:
                self._active.remove(s)
                self._free_blocks(s)   # same-step free: next admission
                self._finish(s, InferReply("ok"))
                _tm.observe("serving_latency_ms",
                            s.pending.reply.latency_ms, model=m.name)
        if n_generated:
            _tm.inc("serving_tokens_generated_total", n_generated,
                    model=m.name)
        _tm.inc("serving_decode_steps_total", model=m.name)
        _tm.observe("decode_batch_occupancy", len(lanes) / float(bucket),
                    model=m.name)
        sspan.annotate(generated=n_generated, ms=round(ms, 3)).end()
        return True


# ===========================================================================
# Batch inference serving over AnalysisPredictor
# ===========================================================================
#
# Counterpart of the reference's ``ServingEngine``
# (paddle_tpu/serving/engine.py:244-762):
#
# - admission with deadline-aware backpressure: ``submit`` sheds (status
#   "shed" + retry_after_ms) when the queue is full or when the projected
#   wait (queue depth x the model's EWMA batch time) exceeds the request's
#   deadline scaled by its tier weight; a queued request whose deadline
#   passes before dispatch completes "timeout";
# - SLO tiers: the weight orders batch assembly and decides queue-full
#   eviction (a higher-weight arrival evicts the lowest-weight queued
#   request);
# - shape-bucketed batching: the dispatcher coalesces same-model requests
#   for up to ``batch_window_ms`` and pads the batch to the smallest
#   bucket that fits, so every run has one of a fixed set of shapes;
# - ``prewarm`` runs one forward per (model, bucket), which builds the
#   kernels and pays the libraries' first-call costs before traffic;
# - ``drain`` for graceful retirement and versioned routing
#   (``set_route``) for canary rollouts.
#
# Its telemetry is the reference's (requests, sheds by reason and tier,
# timeouts, batch errors, latency / execute / server_ms histograms, batch
# fill, deadline goodput, qps, rollout_state); ``batch_log`` also keeps the
# last batches' bucket, rows and execute time.  Its spans, its
# ``batch_start`` note and its ``serving.execute.<model>`` fault point are
# in the module docstring.

_DEFAULT_TIER_WEIGHTS = "paid:1.0,free:0.45,batch:0.15"


def parse_tier_weights(spec=_DEFAULT_TIER_WEIGHTS):
    """\"paid:1.0,free:0.45\" -> {tier: weight}; weights in (0, 1]."""
    if isinstance(spec, dict):
        out = {str(k): float(v) for k, v in spec.items()}
    else:
        out = {}
        for part in str(spec).replace(" ", "").split(","):
            if not part:
                continue
            name, _, w = part.partition(":")
            if not name or not w:
                raise ValueError("tier weights want tier:weight, got %r"
                                 % part)
            out[name] = float(w)
    if not out or any(w <= 0.0 or w > 1.0 for w in out.values()):
        raise ValueError("tier weights must be in (0, 1]: %r" % spec)
    return out


def tier_weight(weights, tier):
    """(tier label, weight) of one request: no tier is the full budget,
    an unknown tier the lowest configured weight."""
    if not tier:
        return "default", 1.0
    w = weights.get(tier)
    return (tier, w) if w is not None else (tier, min(weights.values()))


def _route_hash(req_id):
    """Deterministic [0, 1) split point per request, so a replayed request
    lands on the same version."""
    return (zlib.crc32(req_id.encode("utf-8")) & 0xFFFFFFFF) / 2.0 ** 32


class _InferPending(_Pending):
    __slots__ = ("tenant", "feeds", "rows", "t_dispatch", "tier", "weight")

    def __init__(self, model, tenant, feeds, deadline_ms, req_id, callback,
                 tier="default", weight=1.0, traceparent=None):
        super().__init__(model, deadline_ms, req_id, callback,
                         traceparent=traceparent)
        self.tenant = tenant
        self.feeds = feeds
        self.rows = 0
        self.t_dispatch = None
        self.tier = tier
        self.weight = float(weight)


class _ModelEntry:
    __slots__ = ("name", "predictor", "feed_specs", "svc_ms")

    def __init__(self, name, predictor):
        self.name = name
        self.predictor = predictor
        block = predictor.program().global_block()
        self.feed_specs = {}
        for fname in predictor.get_input_names():
            shape = tuple(block.var(fname).shape)
            if shape and shape[0] in (-1, 0):
                shape = shape[1:]
            self.feed_specs[fname] = (shape, block.var(fname).dtype)
        self.svc_ms = 0.0  # EWMA of one batch's wall time


class ServingEngine:
    """Batched inference over ``save_inference_model`` directories, on
    ``device`` (default ``cuda``; the CPU only when asked).  The defaults
    are the reference's flag defaults: buckets "1,4,16,64", a queue of
    256, a 2000 ms deadline, a 2 ms batch window."""

    def __init__(self, buckets="1,4,16,64", max_queue=256,
                 deadline_ms=2000.0, batch_window_ms=2.0,
                 tier_weights=_DEFAULT_TIER_WEIGHTS, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.buckets = parse_buckets(buckets)
        self.max_queue = int(max_queue)
        self.default_deadline_ms = float(deadline_ms)
        self.batch_window_ms = float(batch_window_ms)
        self.tier_weights = parse_tier_weights(tier_weights)
        self._models = {}
        self._queue = []
        self._routes = {}
        self._cond = threading.Condition()
        self._running = False
        self._draining = False
        self._thread = None
        self.in_batch = False
        # called outside the queue lock after every dispatched batch (the
        # fleet's tick), so a membership change lands between batches
        self.on_batch_boundary = None
        self._done_times = []     # completion stamps of the qps gauge
        # {"model", "bucket", "rows", "requests", "execute_ms"} per batch
        self.batch_log = collections.deque(maxlen=4096)
        self._batches_run = 0

    @property
    def batches(self):
        """Batches run so far (each is one run_feed of a predictor)."""
        return self._batches_run

    # -- registry ------------------------------------------------------------

    def add_model(self, name, predictor_or_dir):
        """Register ``name``: an AnalysisPredictor, or a
        save_inference_model directory (of either package), loaded into a
        predictor on this engine's device."""
        from ..inference import AnalysisConfig, AnalysisPredictor

        if isinstance(predictor_or_dir, str):
            cfg = AnalysisConfig(predictor_or_dir)
            if self.device.type == "cuda":
                cfg.enable_use_gpu(device_id=self.device.index or 0)
            else:
                cfg.disable_gpu()
            predictor_or_dir = AnalysisPredictor(cfg)
        self._models[name] = _ModelEntry(name, predictor_or_dir)
        return self._models[name].predictor

    def models(self):
        return list(self._models)

    def spec(self, model):
        """JSON-able feed/fetch signature of ``model``."""
        from ..framework import dtype_to_np

        e = self._models[model]
        return {"model": model, "buckets": list(self.buckets),
                "feeds": {n: {"shape": list(shape),
                              "dtype": dtype_to_np(dt).str}
                          for n, (shape, dt) in e.feed_specs.items()},
                "outputs": e.predictor.get_output_names()}

    # -- versioned routing ---------------------------------------------------

    def set_route(self, base, active=None, canary=None, fraction=0.0,
                  state="stable"):
        """Requests addressed to ``base`` go to ``active``, except a
        ``fraction`` of them to ``canary``; a version named directly
        bypasses routing."""
        active = active or base
        if active not in self._models:
            raise ValueError("unknown active version %r" % active)
        if canary is not None and canary not in self._models:
            raise ValueError("unknown canary version %r" % canary)
        with self._cond:
            self._routes[base] = {
                "active": active, "canary": canary,
                "fraction": float(fraction) if canary is not None else 0.0,
                "state": state}
        _tm.set_gauge("rollout_state",
                      {"stable": 0, "canary": 1, "flipped": 2,
                       "rolled_back": 3}.get(state, 0), model=base)

    def clear_route(self, base):
        with self._cond:
            self._routes.pop(base, None)

    def routes(self):
        with self._cond:
            return {b: dict(r) for b, r in self._routes.items()}

    def apply_routes(self, routes):
        """Adopt a broadcast route table; a route naming a version this
        engine lacks is skipped, so it never routes into nothing."""
        for base, r in (routes or {}).items():
            try:
                self.set_route(base, active=r.get("active"),
                               canary=r.get("canary"),
                               fraction=r.get("fraction", 0.0),
                               state=r.get("state", "stable"))
            except ValueError:
                continue

    def resolve(self, model, req_id):
        r = self._routes.get(model)
        if not r:
            return model
        if r["canary"] is not None and r["fraction"] > 0.0 \
                and _route_hash(req_id) < r["fraction"]:
            return r["canary"]
        return r["active"]

    # -- prewarm -------------------------------------------------------------

    def prewarm(self):
        """One forward per (model, bucket) on zero feeds; returns the
        manifest {model: {bucket: {"source", "compile_ms"}}} ("compiled"
        the first time a bucket's plan is built, "memory" after)."""
        manifest = {}
        for name, e in self._models.items():
            pred = e.predictor
            per = {}
            for b in self.buckets:
                specs = {n: ((b,) + tuple(shape), dt)
                         for n, (shape, dt) in e.feed_specs.items()}
                got = pred.warmup(specs)
                per[b] = {"source": got["source"],
                          "compile_ms": round(got["compile_ms"], 3)}
                _tm.inc("serving_prewarm_total", model=name,
                        source=got["source"])
                _tm.event("serving_prewarm", model=name, bucket=b,
                          source=got["source"],
                          ms=round(got["compile_ms"], 3))
            manifest[name] = per
        return manifest

    # -- admission -----------------------------------------------------------

    def _projected_wait_ms(self, entry, depth):
        """Batches ahead x EWMA batch time."""
        if entry.svc_ms <= 0.0:
            return 0.0
        return (depth // max(self.buckets) + 1) * entry.svc_ms

    @staticmethod
    def _shed(req, reason, error, retry_after_ms):
        _tm.inc("serving_shed_total", reason=reason)
        _tm.inc("serving_tier_shed_total", tier=req.tier)
        req.complete(InferReply("shed", error=error,
                                retry_after_ms=retry_after_ms,
                                phases={"tier": req.tier,
                                        "model": req.model}))
        return req

    def submit(self, model, feeds, tenant="default", deadline_ms=None,
               callback=None, req_id=None, tier=None, traceparent=None):
        """Enqueue one request; returns a handle whose ``wait()`` gives the
        InferReply.  Shed and malformed requests complete at once.
        ``traceparent`` (the wire context) is echoed in the reply meta."""
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        req_id = req_id or uuid.uuid4().hex
        tier, weight = tier_weight(self.tier_weights, tier)
        model = self.resolve(model, req_id)
        req = _InferPending(model, tenant, feeds, deadline_ms, req_id,
                            callback, tier=tier, weight=weight,
                            traceparent=traceparent)
        entry = self._models.get(model)
        if entry is None or not self._running:
            req.complete(InferReply(
                "error", error="unknown model %r" % model if entry is None
                else "engine not running"))
            return req
        try:
            req.feeds, req.rows = self._normalize(entry, feeds)
        except ValueError as e:
            req.complete(InferReply("error", error=str(e)))
            return req
        _tm.inc("serving_requests_total", model=model, tenant=tenant)
        with self._cond:
            if self._draining:
                return self._shed(req, "draining", "replica draining",
                                  max(entry.svc_ms, 1.0))
            depth = len(self._queue)
            if depth >= self.max_queue:
                wait_ms = self._projected_wait_ms(entry, depth)
                victim = min(self._queue,
                             key=lambda r: (r.weight, -r.t_submit)) \
                    if self._queue else None
                if victim is not None and victim.weight < req.weight:
                    # a full queue sheds its lowest-weight member when the
                    # arrival outranks it
                    self._queue.remove(victim)
                    if victim.qspan is not None:
                        victim.qspan.annotate(evicted=True).end()
                    if victim.span is not None:
                        victim.span.annotate(status="shed").end()
                    self._shed(victim, "tier_evicted",
                               "evicted by %s-tier arrival" % req.tier,
                               max(wait_ms, entry.svc_ms, 1.0))
                else:
                    return self._shed(req, "queue_full",
                                      "queue full (%d)" % depth,
                                      max(wait_ms, entry.svc_ms, 1.0))
            wait_ms = self._projected_wait_ms(entry, len(self._queue))
            budget_ms = deadline_ms * req.weight
            if wait_ms > budget_ms:
                return self._shed(
                    req, "deadline_budget",
                    "projected wait %.0fms exceeds %s-tier budget "
                    "%.0fms" % (wait_ms, req.tier, budget_ms),
                    wait_ms - budget_ms + entry.svc_ms)
            # admitted: the request span (under the server's admission
            # span when submitted inside it) and its queue-wait child,
            # ended at dispatch or expiry
            req.span = _tr.start_span(
                "serving.request", model=model, tenant=tenant,
                rows=req.rows, req_id=req.req_id, tier=tier)
            req.qspan = _tr.start_span("serving.queue_wait",
                                       parent=req.span, depth=depth)
            self._queue.append(req)
            _tm.set_gauge("serving_queue_depth", len(self._queue))
            self._cond.notify_all()
        return req

    def infer(self, model, feeds, tenant="default", deadline_ms=None,
              tier=None):
        """Synchronous submit + wait."""
        req = self.submit(model, feeds, tenant=tenant,
                          deadline_ms=deadline_ms, tier=tier)
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        reply = req.wait(timeout=deadline_ms / 1e3 + 30.0)
        return reply if reply is not None else InferReply(
            "timeout", error="no reply within deadline")

    def _normalize(self, entry, feeds):
        """Validate and coerce a request's feeds -> (feeds, rows)."""
        from ..framework import dtype_to_np

        rows = None
        out = {}
        for name, (shape, dt) in entry.feed_specs.items():
            if name not in feeds:
                raise ValueError("missing feed %r" % name)
            arr = np.ascontiguousarray(feeds[name], dtype=dtype_to_np(dt))
            if tuple(arr.shape[1:]) != tuple(shape):
                raise ValueError("feed %r: expected trailing shape %s, got "
                                 "%s" % (name, tuple(shape),
                                         tuple(arr.shape[1:])))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError("inconsistent batch rows across feeds")
            out[name] = arr
        if not rows:
            raise ValueError("empty request")
        if rows > max(self.buckets):
            raise ValueError("request rows %d exceed largest bucket %d"
                             % (rows, max(self.buckets)))
        return out, rows

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="serving-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain_s=5.0):
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(drain_s)
            self._thread = None
        with self._cond:
            left, self._queue = self._queue, []
        for req in left:
            req.complete(InferReply("error", error="engine stopped"))
            if req.qspan is not None:
                req.qspan.end()
            if req.span is not None:
                req.span.annotate(status="error").end()

    @property
    def draining(self):
        return self._draining

    def drain(self, timeout_s=30.0):
        """Shed new arrivals and wait until every admitted request has
        been dispatched and the running batch finished; True when the
        engine emptied in time."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            with self._cond:
                if not self._queue and not self.in_batch:
                    return True
            time.sleep(0.01)
        return False

    # -- dispatcher ----------------------------------------------------------

    def _bucket_for(self, rows):
        for b in self.buckets:
            if rows <= b:
                return b
        return max(self.buckets)

    def _collect(self):
        """Under the lock: wait for work, then coalesce one model's
        requests within the batch window up to the largest bucket, the
        highest tier weight first (FIFO within a tier)."""
        while self._running and not self._queue:
            self._cond.wait(0.2)
        if not self._queue:
            return None, []
        model = self._queue[0].model
        window_end = time.perf_counter() + self.batch_window_ms / 1e3
        max_rows = max(self.buckets)
        while self._running:
            if sum(r.rows for r in self._queue if r.model == model) \
                    >= max_rows:
                break
            left = window_end - time.perf_counter()
            if left <= 0:
                break
            self._cond.wait(min(left, 0.002))
        cands = sorted((r for r in self._queue if r.model == model),
                       key=lambda r: (-r.weight, r.t_submit))
        batch, rows = [], 0
        for r in cands:
            if rows + r.rows <= max_rows:
                batch.append(r)
                rows += r.rows
        taken = set(map(id, batch))
        self._queue[:] = [r for r in self._queue if id(r) not in taken]
        _tm.set_gauge("serving_queue_depth", len(self._queue))
        # set under the lock, so drain() never sees an empty queue while
        # a collected batch has yet to run
        self.in_batch = bool(batch)
        return model, batch

    def _dispatch_loop(self):
        while True:
            with self._cond:
                if not self._running:
                    return
                model, batch = self._collect()
            if not batch:
                continue
            try:
                now = time.perf_counter()
                live = []
                for r in batch:
                    if now > r.deadline:
                        _tm.inc("serving_timeout_total", model=r.model)
                        r.complete(InferReply(
                            "timeout", error="deadline expired in queue",
                            phases={"queue_wait_ms":
                                    round((now - r.t_submit) * 1e3, 3),
                                    "rows": r.rows}))
                        if r.qspan is not None:
                            r.qspan.annotate(expired=True).end()
                        if r.span is not None:
                            r.span.annotate(status="timeout").end()
                    else:
                        r.t_dispatch = now
                        if r.qspan is not None:
                            r.qspan.end()
                        live.append(r)
                if live:
                    self._run_batch(self._models[model], live)
            finally:
                with self._cond:
                    self.in_batch = False
            if self.on_batch_boundary is not None:
                try:
                    self.on_batch_boundary()
                except Exception:  # the hook never stops the dispatcher
                    _log.exception("on_batch_boundary failed")

    @staticmethod
    def _phases(r, execute_ms, bucket):
        t_d = r.t_dispatch if r.t_dispatch is not None else r.t_submit
        return {"queue_wait_ms": round((t_d - r.t_submit) * 1e3, 3),
                "execute_ms": round(execute_ms, 3), "bucket": bucket,
                "rows": r.rows, "tier": r.tier, "model": r.model}

    def _run_batch(self, entry, batch):
        rows = sum(r.rows for r in batch)
        bucket = self._bucket_for(rows)
        pred = entry.predictor
        # a batch serves requests of several traces: a root span that
        # links their request spans
        bspan = _tr.start_span("serving.batch", model=entry.name,
                               bucket=bucket, rows=rows,
                               requests=len(batch))
        for r in batch:
            bspan.link(r.span.context if r.span is not None else None)
        with _tr.activate(bspan):
            with _tr.span("serving.pad_to_bucket", rows=rows,
                          bucket=bucket):
                feed = {}
                for name in entry.feed_specs:
                    parts = [r.feeds[name] for r in batch]
                    if rows < bucket:
                        parts.append(np.zeros(
                            (bucket - rows,) + parts[0].shape[1:],
                            dtype=parts[0].dtype))
                    feed[name] = np.concatenate(parts, axis=0) \
                        if len(parts) > 1 else parts[0]
            # write-through, before execute: a SIGKILL mid-batch leaves
            # these request ids in flightrec-<pid>.json
            _tr.note("batch_start", model=entry.name, bucket=bucket,
                     req_ids=[r.req_id for r in batch])
            t0 = time.perf_counter()
            try:
                # per model version, so a canary can be made to fail
                if maybe_fail("serving.execute." + entry.name) == "error":
                    raise RuntimeError("injected execute fault (%s)"
                                       % entry.name)
                self._batches_run += 1
                with _tr.span("serving.execute", bucket=bucket):
                    outs = pred.run_feed(feed)
            except Exception as e:  # the engine serves on; the batch fails
                _log.exception("batch of %d rows failed", rows)
                ms = (time.perf_counter() - t0) * 1e3
                for r in batch:
                    r.complete(InferReply("error", error="%s: %s"
                                          % (type(e).__name__, e),
                                          phases=self._phases(r, ms,
                                                              bucket)))
                    if r.span is not None:
                        r.span.annotate(status="error").end()
                _tm.inc("serving_batch_errors_total", model=entry.name)
                _tm.inc("serving_request_errors_total", len(batch),
                        model=entry.name)
                bspan.annotate(error=str(e)[:200]).end()
                return
        ms = (time.perf_counter() - t0) * 1e3
        entry.svc_ms = ms if entry.svc_ms <= 0 else \
            0.7 * entry.svc_ms + 0.3 * ms
        self.batch_log.append({"model": entry.name, "bucket": bucket,
                               "rows": rows, "requests": len(batch),
                               "execute_ms": ms})
        off = 0
        for r in batch:
            # per-request rows of every output that carries the batch dim;
            # batch-free outputs go to every request whole
            sliced = {n: o[off:off + r.rows].copy()
                      if o.ndim and o.shape[0] == bucket else o
                      for n, o in outs.items()}
            off += r.rows
            r.complete(InferReply("ok", outputs=sliced,
                                  phases=self._phases(r, ms, bucket)))
            if r.span is not None:
                r.span.annotate(status="ok", bucket=bucket).end()
            _tm.observe("serving_latency_ms", r.reply.latency_ms,
                        model=entry.name)
            # per-version execute time: the rollout gate's signal
            _tm.observe("serving_execute_ms", ms, model=entry.name)
            # per-tier server-side latency, a mergeable histogram that the
            # fleet monitor's SLO rules window
            _tm.observe("server_ms",
                        r.reply.phases.get("queue_wait_ms", 0.0) + ms,
                        tier=r.tier)
            met = time.perf_counter() <= r.deadline
            _tm.inc("serving_deadline_met_total" if met
                    else "serving_deadline_missed_total", tier=r.tier)
        _tm.inc("serving_batches_total", model=entry.name,
                bucket=str(bucket))
        _tm.observe("serving_batch_fill", rows / float(bucket),
                    model=entry.name)
        bspan.end()
        if _tm.enabled():
            now = time.time()
            self._done_times.extend([now] * len(batch))
            cut = now - _QPS_WINDOW_S
            while self._done_times and self._done_times[0] < cut:
                self._done_times.pop(0)
            _tm.set_gauge("serving_qps",
                          len(self._done_times) / _QPS_WINDOW_S)
