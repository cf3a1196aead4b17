"""Autoregressive decode serving: paged KV cache + token-level batching.

Counterpart of the non-speculative f32 path of ``DecodeEngine`` in
``paddle_tpu/serving/engine.py``.  Every iteration of the decode loop:

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

Left out of this slice, compared with the reference: speculative decode,
int8 KV, disaggregated handoff, session migration and history
publication, tier weights and tier eviction, telemetry and tracing, and
fault injection.
"""

import collections
import logging
import threading
import time
import uuid

import numpy as np
import torch

from ..device import resolve_device, set_f32_numerics
from . import decode_model as _dm
from . import kv_cache as _kvc

__all__ = ["DecodeEngine", "InferReply", "parse_buckets"]

_log = logging.getLogger(__name__)


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


class _Pending:
    """Handle returned by submit(): wait() blocks for the InferReply."""

    __slots__ = ("model", "deadline", "t_submit", "req_id", "callback",
                 "_done", "reply")

    def __init__(self, model, deadline_ms, req_id, callback):
        self.model = model
        self.t_submit = time.perf_counter()
        self.deadline = self.t_submit + deadline_ms / 1e3
        self.req_id = req_id
        self.callback = callback
        self._done = threading.Event()
        self.reply = None

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
                 "step_ms", "step_ms_samples", "prefix")

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

    # -- admission -----------------------------------------------------------

    def _retry_after_ms(self, m):
        """Time for roughly one block's worth of tokens to drain."""
        per = m.step_ms if m.step_ms > 0 else 1.0
        return max(per * m.kv_config.block_size, 1.0)

    def submit(self, model, prompt_ids, max_new_tokens=16, deadline_ms=None,
               eos_id=-1, callback=None, on_token=None, req_id=None):
        """Enqueue one request; returns a _Pending whose reply carries
        outputs={"tokens"} plus queue/TTFT/ITL phases.
        ``on_token(req_id, index, token, done, status)`` fires per
        generated token; on a non-ok end it fires once with token None."""
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        req = _Pending(model, deadline_ms, req_id or uuid.uuid4().hex,
                       callback)

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
        seq = _DecodeSeq(req, prompt_ids, max_new_tokens, eos_id, on_token,
                         m.maxb)
        with self._cond:
            if self._draining:
                return _early(InferReply(
                    "shed", error="replica draining",
                    retry_after_ms=self._retry_after_ms(m)))
            if len(self._waiting) >= self.max_queue:
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
                return _early(InferReply(
                    "shed", error="KV pool exhausted (%d reclaimable "
                    "blocks)" % free_now,
                    retry_after_ms=self._retry_after_ms(m)))
            self._waiting.append(seq)
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
                    self._finish(s, InferReply("aborted",
                                               error="aborted by client"))
                    return True
            for s in self._active:
                if s.pending.req_id == req_id and not s.aborted:
                    s.aborted = True   # freed at the next step boundary
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
            self._active.append(s)

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
            with self._cond:
                if not self._running:
                    return
                self._expire_and_admit()
                if not self._active:
                    self._cond.wait(0.05)
                    continue
                step_ok = self._decode_step_locked()
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
        t0 = time.perf_counter()
        err = None
        self._cond.release()
        try:
            dev = self.device
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
        if not self._running:
            return True     # stopping: stop() finishes every sequence
        if err is not None:
            for s in lanes:
                self._active.remove(s)
                self._free_blocks(s)
                self._finish(s, InferReply(
                    "error", error="%s: %s" % (type(err).__name__, err)))
            return False
        ms = (time.perf_counter() - t0) * 1e3
        m.step_ms = ms if m.step_ms <= 0 else 0.8 * m.step_ms + 0.2 * ms
        m.step_ms_samples.append(ms)
        t_tok = time.perf_counter()
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
        return True
