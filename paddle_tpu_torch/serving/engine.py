"""Serving engines of the port: ``DecodeEngine`` (autoregressive decode,
paged KV cache + token-level batching) and ``ServingEngine`` (batched
inference over AnalysisPredictor, at the end of this module).

``DecodeEngine`` is the counterpart of ``DecodeEngine`` in
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

Int8 KV residency (``kv_dtype="int8"``, default ``FLAGS_kv_cache_dtype``)
keeps the pools in int8 with a max-abs scale a (block, position, head);
the step quantizes each token's K/V and attends through
``paged_attention_int8``.  Speculative decode (``speculative_k`` > 0,
default ``FLAGS_speculative_k``, with a bundled draft decoder) replaces
step 3 by one iteration of ``_spec_step_locked``: the draft proposes k
tokens a generating lane through its own paged pool (one
``draft_rollout``), ONE (k+1)-column target ``paged_step_multi``
verifies them, the longest prefix matching the target's greedy chain is
accepted, both pools roll back to the accepted frontier in the same
iteration (``trim_table``), and the draft catches up on what it missed
(one ``paged_step_multi`` ingest).  Prefill lanes ride the verify as
chunks of up to k+1 prompt tokens.  Greedy accept keeps the tokens those
of the non-speculative engine; the draft only moves the speed.

Both engines emit the reference's serving metrics into the port's
telemetry registry (``core/telemetry.py``, inert unless
``FLAGS_telemetry``), under the reference's names, labels and buckets,
and call ``on_batch_boundary`` (the fleet's eviction hook) between
batches and between decode steps, never while ``in_batch`` is true.
``DecodeEngine.prewarm`` runs one step per lane bucket (speculative:
the verify, rollout and ingest once each).

Both engines trace as the reference does (``core/tracing.py``, inert
unless ``FLAGS_tracing``): an admitted request opens ``serving.request``
(under the server's admission span when submitted inside it) with a
``serving.queue_wait`` child ended at admission to a lane or dispatch; a
decode step is a ``serving.decode_step`` span linking each lane's request
span (speculative: with ``serving.draft``, ``serving.verify`` and
``serving.draft_ingest`` children, ``k_proposed`` and ``k_accepted``
attrs, and a ``decode_step`` note a phase), an encoder batch a
``serving.batch`` span linking its requests, with
``serving.pad_to_bucket`` and ``serving.execute`` (the Executor's
``executor.step`` nests under it) as children.  Before the device work
starts, a write-through ``note`` (``decode_step`` or ``batch_start``)
names the request ids, so a SIGKILLed replica's
``flightrec-<pid>.json`` holds its in-flight work.  Fault points
(``utils/fault_injection.py``): ``serving.decode_step``, checked outside
the lock before each decode iteration that has work, and
``serving.execute.<model>``, checked before a batch runs ("error" fails
the batch).

Moving decode state between replicas (``serving/disagg.py``,
``serving/migrate.py``), as the reference does:

- **handoff** (``submit(handoff=True)``, the prefill role): the sequence
  is fed up to ``handoff_prefill_upto`` (its last full-block boundary),
  ``on_block_sealed(m, seq, j, digest)`` fires for each sealed prompt
  block (prefix hits at admission included) and ``on_handoff(m, seq)``
  once at the boundary, both on the decode thread between steps; it then
  finishes with status "handoff" and never generates.
  ``adopt_kv_block`` installs a transferred block on the decode role
  (allocate, ``import_block``, publish under its digest, park it
  evictable), so the commit's ordinary submit prefix-matches it;
  ``forget_adopted`` frees the blocks of a request that died.
- **history publication** (``FLAGS_session_migration``): each completed
  block of prompt ++ emitted tokens is published under that history's
  chain digest, after the appends, in the plain and speculative steps.
- **migration**: ``export_session`` detaches a live sequence between
  steps and snapshots a manifest, its sealed history blocks and a tail
  block (``migrate.tail_digest``); the sequence stays parked until
  ``commit_migration`` (finish "migrated", ``migrated_to`` in the phases)
  or ``abort_migration`` (re-queue at the front; its tokens are kept and
  replayed, never re-emitted).  ``submit(resume_from=, resume_tail=)``
  admits a resumed session: it matches the full history chain, installs
  the tail into a private block when every full block below it matched
  and its digest agrees, and emits from index ``len(resume_from)``.
  ``drain(migrate=)`` pushes live sessions instead of waiting them out;
  ``on_preempt`` (fired with the lock released) names the sequences a
  preemption re-queued, for the pressure trigger.

The decode step runs with the lock released (``_decode_step_locked``),
so whatever reads or writes the pools from another thread
(``export_session``, ``adopt_kv_block``) runs between two steps
(``_between_steps``): inline when no step is on the device, else queued
for the decode thread, which runs it at the top of its next iteration.

SLO tiers, as the reference's: ``submit(tier=)`` resolves the request's
weight through ``tier_weight`` (no tier weighs 1.0, an unknown tier the
lowest configured weight); a full waiting queue evicts its lowest-weight
member, the newest among equals, when the arrival outranks it, and sheds
the arrival otherwise.  The tier and the tenant ride the session
manifest, the reply phases and the per-tier counters and histograms.
Where a constructor argument is None, both engines read the serving
flags (``flags.py``) as the reference's do.
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
from ..flags import flag as _flag
from ..utils.fault_injection import maybe_fail
from . import decode_model as _dm
from . import kv_cache as _kvc

__all__ = ["DecodeEngine", "ServingEngine", "InferReply", "parse_buckets",
           "parse_tier_weights", "tier_weight"]

_log = logging.getLogger(__name__)

_QPS_WINDOW_S = 5.0         # trailing window of the serving_qps gauge


def _or_flag(value, name):
    """A constructor argument, or its flag when it is None."""
    return value if value is not None else _flag(name)


def parse_buckets(spec=None):
    """\"1,4,16\" (or an int sequence; None reads
    ``FLAGS_serving_buckets``) -> sorted unique bucket tuple."""
    if spec is None:
        spec = _flag("serving_buckets")
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

    __slots__ = ("model", "tenant", "tier", "weight", "deadline", "t_submit",
                 "req_id", "callback", "_done", "reply", "traceparent",
                 "span", "qspan")

    def __init__(self, model, deadline_ms, req_id, callback,
                 traceparent=None, tenant="default", tier="default",
                 weight=1.0):
        self.model = model
        self.tenant = tenant
        self.tier = tier
        self.weight = float(weight)
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
                 "blocks", "table", "draft_blocks", "draft_table", "n_fed",
                 "next_tok", "out", "t_admit", "t_first", "token_times",
                 "admit_seq", "aborted", "hashes", "published",
                 "cached_tokens", "replay_upto", "handoff", "prefill_upto",
                 "resume_tail", "hist_hashes", "hist_published")

    def __init__(self, pending, prompt, max_new, eos_id, on_token, maxb):
        self.pending = pending
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = int(eos_id)
        self.on_token = on_token
        self.blocks = []                      # allocator block ids held
        self.table = np.full(maxb, -1, np.int32)
        self.draft_blocks = []                # the draft pool's, speculating
        self.draft_table = np.full(maxb, -1, np.int32)
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
        # the prefill role: feed up to prefill_upto, never generate
        self.handoff = False
        self.prefill_upto = 0
        # a migrated tail block, consumed once at admission; the chain over
        # prompt ++ out and how many of its blocks are published
        self.resume_tail = None
        self.hist_hashes = []
        self.hist_published = 0

    @property
    def in_prefill(self):
        return self.n_fed < self.replay_upto

    def feed_tok(self, i):
        p = len(self.prompt)
        return self.prompt[i] if i < p else self.out[i - p]

    def feed_slice(self, start, span):
        return [self.feed_tok(i) for i in range(start, start + span)]

    @property
    def total(self):
        return len(self.prompt) + self.max_new

    def reset_for_recompute(self):
        """Preempted, or a migration aborted: blocks were freed; replay
        prompt ++ out from the start (or from a prefix-cache hit, the
        published history included) with outputs discarded."""
        self.blocks = []
        self.table.fill(-1)
        self.draft_blocks = []
        self.draft_table.fill(-1)
        self.n_fed = 0
        self.next_tok = self.prompt[0]
        self.replay_upto = len(self.prompt) + len(self.out)
        self.t_first = None
        self.token_times = []
        self.hashes = None
        self.published = 0
        self.cached_tokens = 0
        self.hist_hashes = []
        self.hist_published = 0


class _DecodeModel:
    __slots__ = ("name", "cfg", "decoder", "kv_config", "cache", "maxb",
                 "step_ms", "step_ms_samples", "prefix", "warmed",
                 # speculative decode (spec_k 0 = off): the draft decoder
                 # and its own paged pool of the target's block count
                 "spec_k", "draft", "draft_cache", "verifies", "rollouts",
                 "ingests")

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
        self.spec_k = 0
        self.draft = self.draft_cache = None
        # target verify, draft rollout and draft ingest calls so far
        self.verifies = self.rollouts = self.ingests = 0


class DecodeEngine:
    """Token-level continuous batching over an engine-owned paged KV
    cache, on ``device`` (default ``cuda``; the CPU only when asked).

    An argument left None reads its flag, as the reference's engine does:
    ``buckets`` ``FLAGS_serving_decode_buckets`` ("4,8"), ``max_queue``
    ``FLAGS_serving_max_queue`` (256), ``deadline_ms``
    ``FLAGS_serving_deadline_ms`` (2000), ``mode``
    ``FLAGS_serving_decode_mode`` ("token"), ``block_size``
    ``FLAGS_kv_block_size`` (16), ``prefix_cache`` ``FLAGS_prefix_cache``
    (on), ``prefill_token_budget`` ``FLAGS_decode_prefill_token_budget``
    (0, none) and ``kv_dtype`` ``FLAGS_kv_cache_dtype`` ("f32" or
    "int8"); the tier weights are ``FLAGS_serving_tier_weights``'s."""

    def __init__(self, buckets=None, max_queue=None, deadline_ms=None,
                 mode=None, block_size=None, prefix_cache=None,
                 prefill_token_budget=None, kv_dtype=None, device=None):
        self.device = resolve_device(device)
        self.kv_dtype = str(_or_flag(kv_dtype, "kv_cache_dtype"))
        if self.kv_dtype not in ("f32", "int8"):
            raise ValueError("kv_cache dtype must be f32|int8: %r"
                             % self.kv_dtype)
        set_f32_numerics()
        self.buckets = parse_buckets(_or_flag(buckets,
                                              "serving_decode_buckets"))
        self.max_queue = int(_or_flag(max_queue, "serving_max_queue"))
        self.default_deadline_ms = float(_or_flag(deadline_ms,
                                                  "serving_deadline_ms"))
        mode = _or_flag(mode, "serving_decode_mode")
        if mode not in ("token", "request"):
            raise ValueError("serving_decode_mode must be token|request, "
                             "got %r" % (mode,))
        self.mode = mode
        self.block_size = int(_or_flag(block_size, "kv_block_size"))
        self.prefix_cache = bool(_or_flag(prefix_cache, "prefix_cache"))
        self.prefill_token_budget = int(_or_flag(
            prefill_token_budget, "decode_prefill_token_budget") or 0)
        self.tier_weights = parse_tier_weights()
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
        # the prefill role's hooks (serving/server.py wires them), fired on
        # the decode thread between steps: on_block_sealed(m, seq, j,
        # digest) per sealed prompt block of a handoff sequence,
        # on_handoff(m, seq) once it reaches its boundary
        self.on_block_sealed = None
        self.on_handoff = None
        # migration: sequences parked mid-hand-off, a ring of req_ids
        # committed away (the double-migration refusal), and the
        # preemption victims on_preempt(list of (req_id, model)) gets at
        # the next boundary, with the lock released
        self._migrating = {}
        self._migrated = []
        self._preempted = []
        self.on_preempt = None
        # (fn, result box, done event) queued for the decode thread while
        # a step is on the device (_between_steps)
        self._boundary_calls = []

    @property
    def steps(self):
        """Decode steps run so far (each is one paged_step call, or one
        speculative iteration)."""
        return self._step_no

    # -- registry ------------------------------------------------------------

    def add_model(self, name, source, kv_blocks=None, draft=None,
                  speculative_k=None):
        """Register a decode model: ``source`` is a save_decoder()
        directory of either package or a (DecoderConfig, numpy params)
        pair.  The KV pool's size is ``kv_blocks`` (None reads
        ``FLAGS_kv_cache_blocks``; 0 = auto, 64), capped by
        ``FLAGS_hbm_budget_bytes`` (device bytes) net of the weights'.

        ``draft`` is an optional (DecoderConfig, params) draft decoder (a
        directory source loads its bundled ``<dir>/draft``);
        ``speculative_k`` (None = ``FLAGS_speculative_k``) > 0 with a draft
        turns speculative decode on.  The draft's vocab and max_seq must
        be the target's; its pool gets the target's block count and
        dtype, so any sequence the target pool holds, the draft's can
        shadow."""
        if isinstance(source, str):
            cfg, params = _dm.load_decoder(source)
            if draft is None:
                draft = _dm.load_draft(source)
        else:
            cfg, params = source
        k = int(speculative_k if speculative_k is not None
                else _flag("speculative_k") or 0)
        if draft is None:
            k = 0   # no draft: non-speculative whatever k asks
        resident = sum(int(np.asarray(v).nbytes) for v in params.values())
        if k > 0:
            dcfg, dparams = draft
            resident += sum(int(np.asarray(v).nbytes)
                            for v in dparams.values())
            if dcfg.vocab != cfg.vocab:
                raise ValueError("draft vocab %d != target vocab %d"
                                 % (dcfg.vocab, cfg.vocab))
            if dcfg.max_seq != cfg.max_seq:
                raise ValueError("draft max_seq %d != target max_seq %d "
                                 "(block tables must line up)"
                                 % (dcfg.max_seq, cfg.max_seq))
        kv_config = _kvc.KVCacheConfig(
            layers=cfg.layers, heads=cfg.heads, head_dim=cfg.head_dim,
            block_size=self.block_size, num_blocks=2, dtype=self.kv_dtype)
        kv_config.num_blocks = _kvc.plan_num_blocks(
            kv_config, model_resident_bytes=resident, requested=kv_blocks)[0]
        cache = _kvc.PagedKVCache(kv_config, device=self.device)
        # the draft pool is never indexed: its blocks only steer
        # acceptance, and verify guards every emitted token
        prefix = _kvc.PrefixCache(cache.allocator, self.block_size,
                                  namespace=name) \
            if self.prefix_cache else None
        decoder = _dm.Decoder(cfg, params, device=self.device)
        m = _DecodeModel(name, cfg, decoder, kv_config, cache, prefix)
        if k > 0:
            m.spec_k = k
            m.draft = _dm.Decoder(dcfg, dparams, device=self.device)
            m.draft_cache = _kvc.PagedKVCache(_kvc.KVCacheConfig(
                layers=dcfg.layers, heads=dcfg.heads,
                head_dim=dcfg.head_dim, block_size=self.block_size,
                num_blocks=kv_config.num_blocks, dtype=self.kv_dtype),
                device=self.device)
        self._models[name] = m
        return m

    def models(self):
        return list(self._models)

    def spec(self, model):
        """JSON-able description of ``model`` (the reference's keys)."""
        m = self._models[model]
        out = {"model": model, "type": "decode",
               "vocab": m.cfg.vocab, "max_seq": m.cfg.max_seq,
               "buckets": list(self.buckets), "mode": self.mode,
               "block_size": m.kv_config.block_size,
               "num_blocks": m.kv_config.num_blocks,
               "kv_dtype": m.kv_config.dtype, "speculative_k": m.spec_k,
               "prefix_cache": m.prefix is not None}
        if m.spec_k > 0:
            out["draft"] = {"layers": m.draft.cfg.layers,
                            "num_blocks": m.draft_cache.config.num_blocks,
                            "kv_bytes": m.draft_cache.nbytes}
        return out

    # -- prewarm -------------------------------------------------------------

    def prewarm(self):
        """One decode step per (model, lane bucket) before any request:
        every lane feeds token 0 at position 0 through the scratch block 0
        (context length 1), so the step's kernels and libraries are loaded
        and run at each bucket's shape; a speculative model runs its
        verify, rollout and ingest once each instead.  Returns the
        manifest {model: {bucket: {"source", "compile_ms"}}} (speculative:
        {bucket: {"verify" | "draft_rollout" | "draft_ingest": {...}}}):
        "compiled" the first time a (model, bucket) runs, "memory" after,
        and the call's wall ms."""
        manifest = {}
        dev = self.device
        for name, m in self._models.items():
            per = {}
            for b in self.buckets:
                source = "memory" if b in m.warmed else "compiled"
                w = m.spec_k + 1
                zeros = lambda *shape: torch.zeros(  # noqa: E731
                    shape, dtype=torch.int32, device=dev)
                ones = lambda *shape: torch.ones(  # noqa: E731
                    shape, dtype=torch.int32, device=dev)
                tables = torch.full((b, m.maxb), -1, dtype=torch.int32,
                                    device=dev)
                if m.spec_k > 0:
                    calls = {
                        "verify": lambda: m.decoder.paged_step_multi(
                            m.cache.pools, zeros(b, w), zeros(b, w),
                            tables, ones(b, w))[0],
                        "draft_rollout": lambda: m.draft.draft_rollout(
                            m.draft_cache.pools, zeros(b), zeros(b), tables,
                            ones(b), zeros(b), m.spec_k),
                        "draft_ingest": lambda: m.draft.paged_step_multi(
                            m.draft_cache.pools, zeros(b, w), zeros(b, w),
                            tables, ones(b, w))[0]}
                else:
                    calls = {None: lambda: m.decoder.paged_step(
                        *m.cache.pools[:2], zeros(b), zeros(b), tables,
                        ones(b), scales=m.cache.pools[2:] or None)[0]}
                per[b] = {}
                for kind, call in calls.items():
                    t0 = time.perf_counter()
                    call().cpu()                # waits for the device
                    ms = (time.perf_counter() - t0) * 1e3
                    got = {"source": source, "compile_ms": round(ms, 3)}
                    if kind is None:
                        per[b] = got
                    else:
                        per[b][kind] = got
                    _tm.inc("serving_prewarm_total", model=name,
                            source=source)
                    _tm.event("serving_prewarm", model=name, bucket=b,
                              source=source, decode=True, ms=round(ms, 3),
                              **({"fn": kind, "k": m.spec_k} if kind
                                 else {}))
                m.warmed.add(b)
            manifest[name] = per
        return manifest

    # -- admission -----------------------------------------------------------

    def _retry_after_ms(self, m):
        """Time for roughly one block's worth of tokens to drain."""
        per = m.step_ms if m.step_ms > 0 else 1.0
        return max(per * m.kv_config.block_size, 1.0)

    @staticmethod
    def _count_shed(reason, tier):
        _tm.inc("serving_shed_total", reason=reason)
        _tm.inc("serving_tier_shed_total", tier=tier)

    def handoff_prefill_upto(self, model, prompt_len):
        """Tokens a prefill-role replica feeds for a prompt of
        ``prompt_len``: its last full-block boundary below the prompt's
        end (only full blocks have a digest, and the decode half computes
        at least one tail token).  0: nothing transfers; forward the
        request whole."""
        m = self._models.get(model)
        if m is None or m.prefix is None:
            return 0
        bs = m.kv_config.block_size
        return max(0, ((int(prompt_len) - 1) // bs) * bs)

    def submit(self, model, prompt_ids, max_new_tokens=16, deadline_ms=None,
               eos_id=-1, callback=None, on_token=None, req_id=None,
               tenant="default", traceparent=None, tier=None, handoff=False,
               resume_from=None, resume_tail=None):
        """Enqueue one request; returns a _Pending whose reply carries
        outputs={"tokens"} plus queue/TTFT/ITL phases.
        ``on_token(req_id, index, token, done, status)`` fires per
        generated token; on a non-ok end it fires once with token None.
        ``tenant`` labels the request counter and rides the session
        manifest; ``tier`` sets the request's weight for queue-full
        eviction (``tier_weight``); ``traceparent`` (the wire context) is
        echoed in the reply meta.

        ``handoff=True`` is the prefill role: feed up to
        ``handoff_prefill_upto``, fire the hooks, finish "handoff".
        ``resume_from`` (the tokens a client already holds, or a migrated
        session's) seeds the output: admission matches the history chain
        prompt ++ tokens and emission resumes at the next new index;
        ``resume_tail`` ({"digest", "valid", "arrays"}) is a migrated
        tail block, installed when it checks out and else dropped (the
        replay recomputes it).  A resume of a req_id live here is refused
        (double migration)."""
        deadline_ms = float(deadline_ms or self.default_deadline_ms)
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        tier, weight = tier_weight(self.tier_weights, tier)
        req = _Pending(model, deadline_ms, req_id or uuid.uuid4().hex,
                       callback, traceparent=traceparent, tenant=tenant,
                       tier=tier, weight=weight)

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
        if m.spec_k > 0 and m.draft_cache.blocks_for_tokens(total) > \
                m.draft_cache.allocator.capacity:
            return _early(InferReply(
                "error", error="sequence needs %d draft KV blocks, pool "
                "holds %d" % (m.draft_cache.blocks_for_tokens(total),
                              m.draft_cache.allocator.capacity)))
        if handoff:
            upto = self.handoff_prefill_upto(model, len(prompt_ids))
            if upto <= 0:
                return _early(InferReply(
                    "error", error="nothing to hand off: prompt of %d has "
                    "no full %d-token block below its tail"
                    % (len(prompt_ids), m.kv_config.block_size)))
        resume_out = None
        if resume_from is not None:
            toks = [int(t) for t in np.asarray(resume_from).reshape(-1)]
            err = None
            if handoff:
                err = "resume_from resumes decode; handoff is prefill-role"
            elif not toks:
                err = "resume_from carries no tokens"
            elif len(toks) >= int(max_new_tokens):
                err = "resume_from already holds all %d requested " \
                      "tokens" % int(max_new_tokens)
            elif int(eos_id) >= 0 and int(eos_id) in toks:
                err = "resume_from already contains eos"
            elif any(t < 0 or t >= m.cfg.vocab for t in toks):
                err = "resume token out of vocab"
            if err is not None:
                _tm.inc("kv_migrate_resume_total", result="refused",
                        model=model)
                _tm.inc("kv_migrate_refused_total", reason="bad_resume")
                return _early(InferReply("error", error=err))
            resume_out = toks
        _tm.inc("serving_decode_requests_total", model=model, tenant=tenant)
        seq = _DecodeSeq(req, prompt_ids, max_new_tokens, eos_id, on_token,
                         m.maxb)
        if handoff:
            seq.handoff = True
            seq.prefill_upto = upto
        if resume_out is not None:
            seq.out = resume_out
            seq.replay_upto = len(prompt_ids) + len(resume_out)
            seq.resume_tail = resume_tail
        with self._cond:
            if resume_out is not None and (
                    req.req_id in self._migrating or any(
                        s.pending.req_id == req.req_id
                        for s in self._active + self._waiting)):
                _tm.inc("kv_migrate_resume_total", result="refused",
                        model=model)
                _tm.inc("kv_migrate_refused_total", reason="duplicate")
                return _early(InferReply(
                    "error", error="req_id %s is already live here "
                    "(double migration refused)" % req.req_id))
            if self._draining:
                self._count_shed("draining", tier)
                return _early(InferReply(
                    "shed", error="replica draining",
                    retry_after_ms=self._retry_after_ms(m)))
            if len(self._waiting) >= self.max_queue:
                # a full waiting queue sheds its lowest-weight member, the
                # newest among equals, when the arrival outranks it
                victim = min(self._waiting,
                             key=lambda s: (s.pending.weight,
                                            -s.pending.t_submit)) \
                    if self._waiting else None
                if victim is not None and victim.pending.weight < weight:
                    self._waiting.remove(victim)
                    self._count_shed("tier_evicted", victim.pending.tier)
                    self._finish(victim, InferReply(
                        "shed", error="evicted by %s-tier arrival" % tier,
                        retry_after_ms=self._retry_after_ms(m)))
                else:
                    self._count_shed("queue_full", tier)
                    return _early(InferReply(
                        "shed", error="queue full (%d)" % len(self._waiting),
                        retry_after_ms=self._retry_after_ms(m)))
            # KV pressure: blocks promised to the queue ahead plus this
            # prompt must fit the reclaimable pool (free + zero-ref
            # cached blocks; speculating, the smaller of both pools'),
            # else shed with a drain-time hint
            promised = sum(m.cache.blocks_for_tokens(s.replay_upto)
                           for s in self._waiting
                           if s.pending.model == model)
            need_now = promised + m.cache.blocks_for_tokens(seq.replay_upto)
            free_now = self._reclaimable(m)
            if need_now > free_now:
                self._count_shed("kv_oom", tier)
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
            if resume_out is not None:
                _tm.inc("kv_migrate_resume_total", result="accepted",
                        model=model)
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

    def _between_steps(self, fn):
        """``fn()`` with the lock held and no decode step on the device ->
        its result (or its exception).  Inline when no step runs (the
        lock's holder knows: ``in_batch`` changes only under the lock),
        else queued for the decode thread's next iteration, which cannot
        starve the way a waiter on the lock can."""
        with self._cond:
            if not self.in_batch:
                return fn()
            box = {}
            done = threading.Event()
            self._boundary_calls.append((fn, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("value")

    def _run_boundary_calls_locked(self):
        calls, self._boundary_calls = self._boundary_calls, []
        for fn, box, done in calls:
            try:
                box["value"] = fn()
            except Exception as e:  # handed back to the caller
                box["error"] = e
            done.set()

    # -- sealed-block adoption (the decode half of a disaggregated pair) -----

    def adopt_kv_block(self, model, digest, arrays):
        """Adopt one transferred sealed block into ``model``'s pool:
        allocate a block, install the payload, publish it under
        ``digest`` and park it evictable, so the commit's ordinary submit
        prefix-matches it like a locally computed hit -> "adopted",
        "cached" (the digest is indexed already) or "rejected:<reason>";
        a rejection only costs the decode half a recompute, since the
        commit carries the whole prompt."""
        m = self._models.get(model)
        if m is None:
            return "rejected:unknown model %r" % (model,)
        if m.prefix is None:
            return "rejected:prefix cache disabled"

        def adopt():
            if m.prefix.lookup(digest) is not None:
                _tm.inc("kv_xfer_adopt_total", result="cached", model=model)
                return "cached"
            got = m.cache.allocator.alloc(1)
            if got is None:
                _tm.inc("kv_xfer_adopt_total", result="nopool", model=model)
                return "rejected:kv pool exhausted"
            b = got[0]
            try:
                m.cache.import_block(b, arrays)
            except (ValueError, RuntimeError) as e:
                m.cache.allocator.free([b])
                _tm.inc("kv_xfer_adopt_total", result="geometry",
                        model=model)
                return "rejected:%s" % e
            if not m.prefix.publish(b, digest):
                m.cache.allocator.free([b])
                _tm.inc("kv_xfer_adopt_total", result="cached", model=model)
                return "cached"
            # drop our reference: the sealed block parks evictable
            m.cache.allocator.free([b])
            _tm.inc("kv_xfer_adopt_total", result="adopted", model=model)
            return "adopted"

        return self._between_steps(adopt)

    def forget_adopted(self, model, digests):
        """Un-index and truly free the still-evictable adopted blocks of a
        request that died (a block a live sequence revived is left to it)
        -> how many index entries existed."""
        m = self._models.get(model)
        if m is None or m.prefix is None:
            return 0
        with self._cond:
            n = sum(1 for d in digests if m.prefix.forget(d))
        if n:
            _tm.inc("kv_xfer_forget_total", n, model=model)
        return n

    # -- live session migration (serving/migrate.py drives these) ------------

    def _refuse_export(self, req_id, reason):
        _tm.inc("kv_migrate_refused_total", reason=reason)
        raise ValueError("cannot migrate %s: %s" % (req_id, reason))

    def export_session(self, req_id):
        """Detach a live sequence between two steps and snapshot what a
        peer needs to continue it -> ``(manifest, payloads)``.  The
        manifest is the session's descriptor (its tokens ride as
        ``_prompt_arr`` / ``_out_arr`` int32 arrays, which the migrator
        moves onto the frame's payload); ``payloads`` is one ``(block
        index, digest, arrays, is_tail)`` per block to ship: each fully
        fed history block under its chain digest, and the partial tail
        block under ``tail_digest``.  The sequence stays parked until
        ``commit_migration`` or ``abort_migration``.

        Refusals raise ValueError and leave the engine as it was:
        unknown or finished ids, a sequence parked or recently committed
        away, an aborted or handoff sequence, one still in prefill or
        replay, and an engine without a prefix cache or with
        ``FLAGS_session_migration`` off."""
        return self._between_steps(lambda: self._export_locked(req_id))

    def _export_locked(self, req_id):
        from .migrate import tail_digest

        seq, waiting = None, False
        for s in self._active:
            if s.pending.req_id == req_id:
                seq = s
                break
        if seq is None:
            for s in self._waiting:
                if s.pending.req_id == req_id:
                    seq, waiting = s, True
                    break
        if seq is None:
            if req_id in self._migrating:
                self._refuse_export(req_id, "already_migrating")
            if req_id in self._migrated:
                self._refuse_export(req_id, "already_migrated")
            self._refuse_export(req_id, "unknown")
        if seq.aborted:
            self._refuse_export(req_id, "aborted")
        if seq.handoff:
            self._refuse_export(req_id, "handoff")
        if not seq.out or (not waiting and seq.in_prefill):
            self._refuse_export(req_id, "in_prefill")
        m = self._model_of(seq)
        if m.prefix is None or not _flag("session_migration"):
            self._refuse_export(req_id, "disabled")
        bs = m.kv_config.block_size
        # steady decode keeps n_fed == len(prompt ++ out) - 1 (the last
        # emitted token is fed by the next step); a preempted waiting
        # victim resumes at the same position
        pos = len(seq.prompt) + len(seq.out) - 1 if waiting else seq.n_fed
        nfull = pos // bs
        digests = [self._hist_digest_locked(m, seq, j) for j in range(nfull)]
        payloads = []
        if waiting:
            # a preempted victim freed its blocks; ship the published
            # history that is still evictable, the peer replays the rest
            borrowed = m.prefix.match_digests(digests)
            for j, b in enumerate(borrowed):
                payloads.append((j, digests[j], m.cache.export_block(b),
                                 False))
            if borrowed:
                m.cache.allocator.free(borrowed)
        else:
            for j in range(nfull):
                payloads.append((j, digests[j],
                                 m.cache.export_block(seq.blocks[j]), False))
            if pos > nfull * bs:
                td = tail_digest(digests[-1] if digests else None,
                                 seq.feed_slice(nfull * bs, pos - nfull * bs))
                payloads.append((nfull, td,
                                 m.cache.export_block(seq.blocks[nfull]),
                                 True))
        now = time.perf_counter()
        manifest = {
            "req_id": req_id, "model": seq.pending.model, "pos": int(pos),
            "block_size": int(bs), "dtype": str(m.kv_config.dtype),
            "digests": digests, "max_new_tokens": int(seq.max_new),
            "eos_id": int(seq.eos_id), "tier": seq.pending.tier,
            "tenant": seq.pending.tenant,
            "deadline_ms": max(round((seq.pending.deadline - now) * 1e3, 3),
                               1.0),
            "stream": seq.on_token is not None, "spec_k": int(m.spec_k),
            "_prompt_arr": np.asarray(seq.prompt, np.int32),
            "_out_arr": np.asarray(seq.out, np.int32)}
        if waiting:
            self._waiting.remove(seq)
            _tm.set_gauge("serving_queue_depth", len(self._waiting))
        else:
            self._active.remove(seq)
        self._migrating[req_id] = seq
        _tm.event("session_export", req_id=req_id, pos=int(pos),
                  model=seq.pending.model, blocks=len(payloads),
                  waiting=waiting)
        return manifest, payloads

    def commit_migration(self, req_id, peer):
        """The destination acked "resumed": free the parked sequence's
        blocks and finish it "migrated", ``migrated_to`` in its phases so
        a waiting client follows it."""
        with self._cond:
            seq = self._migrating.pop(req_id, None)
            if seq is None:
                return False
            self._migrated.append(req_id)
            del self._migrated[:-256]
            self._free_blocks(seq)
            self._finish(seq, InferReply(
                "migrated", error="session migrated to %s" % peer,
                phases={"migrated_to": peer}))
            self._cond.notify_all()
        _tm.event("session_migrated", req_id=req_id, peer=peer)
        return True

    def abort_migration(self, req_id):
        """The push failed or was refused: re-queue the parked sequence at
        the front for a local replay (its tokens kept, never re-emitted),
        so at most one replica runs it and nothing is dropped."""
        with self._cond:
            seq = self._migrating.pop(req_id, None)
            if seq is None:
                return False
            self._free_blocks(seq)
            seq.reset_for_recompute()
            self._waiting.insert(0, seq)
            _tm.set_gauge("serving_queue_depth", len(self._waiting))
            self._cond.notify_all()
        return True

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
            self._run_boundary_calls_locked()
            leftovers = self._active + self._waiting + \
                list(self._migrating.values())
            self._active, self._waiting = [], []
            self._migrating = {}
        for s in leftovers:
            self._free_blocks(s)
            self._finish(s, InferReply("error", error="engine stopped"))

    def drain(self, timeout_s=30.0, migrate=None):
        """Shed new arrivals and wait for every waiting and active
        sequence to finish; True when the engine emptied in time.

        ``migrate(req_id, model)`` (``SessionMigrator.drain_push()``)
        pushes each live mid-decode session to a peer instead, one at a
        time, outside the lock; a session whose push fails is waited out
        as before."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.perf_counter() + timeout_s
        failed = set()
        while time.perf_counter() < deadline:
            cand = None
            with self._cond:
                if not self._waiting and not self._active \
                        and not self._migrating:
                    return True
                if migrate is not None:
                    for s in self._active + self._waiting:
                        rid = s.pending.req_id
                        if rid in failed or s.handoff or s.aborted \
                                or not s.out:
                            continue
                        if s in self._active and s.in_prefill:
                            continue
                        cand = (rid, s.pending.model)
                        break
            if cand is not None:
                try:
                    ok = bool(migrate(*cand))
                except Exception:  # a failed push is waited out
                    _log.exception("drain: migrating %s failed", cand[0])
                    ok = False
                if not ok:
                    failed.add(cand[0])
                continue
            time.sleep(0.01)
        return False

    # -- scheduling ----------------------------------------------------------

    def _model_of(self, seq):
        return self._models[seq.pending.model]

    @staticmethod
    def _reclaimable(m):
        """Blocks admission may count on: the target pool's reclaimable
        ones, and when speculating no more than the draft pool's (which
        never seals, so its reclaimable blocks are its free ones)."""
        free = m.cache.allocator.reclaimable
        if m.spec_k > 0:
            free = min(free, m.draft_cache.allocator.reclaimable)
        return free

    def _free_blocks(self, seq):
        m = self._model_of(seq)
        if seq.blocks:
            m.cache.allocator.free(seq.blocks)
            seq.blocks = []
            seq.table.fill(-1)
        if seq.draft_blocks:
            m.draft_cache.allocator.free(seq.draft_blocks)
            seq.draft_blocks = []
            seq.draft_table.fill(-1)

    def _finish(self, seq, reply):
        r = seq.pending
        if reply.ok or reply.status in ("timeout", "migrated"):
            now = time.perf_counter()
            phases = {"queue_wait_ms": round(
                ((seq.t_admit or now) - r.t_submit) * 1e3, 3),
                "tokens": len(seq.out),
                "prompt_tokens": len(seq.prompt),
                "cached_tokens": seq.cached_tokens, "tier": r.tier,
                "model": r.model}
            if seq.replay_upto > len(seq.prompt):
                # tokens re-fed, never re-emitted: a resume's or a
                # replay's; beside cached_tokens, its re-prefill cost
                phases["resumed_tokens"] = seq.replay_upto - len(seq.prompt)
            if seq.t_first is not None:
                phases["ttft_ms"] = round((seq.t_first - r.t_submit) * 1e3, 3)
            if len(seq.token_times) > 1:
                phases["itl_ms_samples"] = [
                    round((b - a) * 1e3, 3) for a, b in
                    zip(seq.token_times, seq.token_times[1:])]
            phases.update(reply.phases)
            reply.phases = phases
        if reply.ok:
            reply.outputs = {"tokens": np.asarray(seq.out, np.int32)}
        r.complete(reply)
        if reply.ok:
            # the fleet-mergeable histograms and the goodput counters
            _tm.observe("server_ms", reply.latency_ms, tier=r.tier)
            if "ttft_ms" in reply.phases:
                _tm.observe("ttft_ms", reply.phases["ttft_ms"],
                            model=r.model)
            for g in reply.phases.get("itl_ms_samples") or ():
                _tm.observe("itl_ms", g, model=r.model)
            met = time.perf_counter() <= r.deadline
            _tm.inc("serving_deadline_met_total" if met
                    else "serving_deadline_missed_total", tier=r.tier)
            if met:
                _tm.inc("serving_deadline_tokens_total", len(seq.out),
                        tier=r.tier)
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
                    self._reclaimable(m):
                break  # head of line waits for blocks to free
            self._waiting.pop(0)
            self._admit_seq += 1
            s.admit_seq = self._admit_seq
            s.t_admit = now
            if m.prefix is not None and s.replay_upto > len(s.prompt):
                # a resumed session or a preempted replay: match the
                # history chain, not the prompt alone
                self._admit_resume_locked(m, s)
            elif m.prefix is not None:
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
                if s.handoff and self.on_block_sealed is not None:
                    # a warm prefill replica still announces its hits: the
                    # decode peer may be cold (the sender skips digests
                    # it already shipped there)
                    want = s.prefill_upto // m.kv_config.block_size
                    for j in range(min(len(shared), want)):
                        self.on_block_sealed(m, s, j, hashes[j])
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
        """Single-token path: cover seq's next write position."""
        return self._ensure_capacity(seq, seq.n_fed + 1)

    def _ensure_capacity(self, seq, upto, draft_upto=0):
        """Grow seq's table to cover ``upto`` tokens (and its draft table
        to ``draft_upto`` when speculating), all or nothing, preempting
        the youngest other active sequence on pool exhaustion.  False
        means seq itself was completed with an error (no victim was
        left)."""
        m = self._model_of(seq)
        while True:
            ok = m.cache.ensure_table(seq.table, seq.blocks, upto)
            if ok and draft_upto > 0:
                ok = m.draft_cache.ensure_table(
                    seq.draft_table, seq.draft_blocks, draft_upto)
            if ok:
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
            if v.out:
                # a pressure-migration candidate, named to on_preempt at
                # the next boundary
                self._preempted.append((v.pending.req_id, v.pending.model))
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
        bs = m.kv_config.block_size
        done = min(s.n_fed, len(s.prompt)) // bs
        while s.published < min(done, len(s.hashes)):
            j = s.published
            m.prefix.publish(s.blocks[j], s.hashes[j])
            s.published = j + 1
            if s.handoff and self.on_block_sealed is not None \
                    and j < s.prefill_upto // bs:
                self.on_block_sealed(m, s, j, s.hashes[j])

    def _hist_digest_locked(self, m, s, j):
        """The ``j``-th full-block digest of the prompt ++ out chain,
        memoized in ``s.hist_hashes`` (its prompt-only blocks are
        ``s.hashes``)."""
        bs = m.kv_config.block_size
        while len(s.hist_hashes) <= j:
            i = len(s.hist_hashes)
            if s.hashes is not None and i < len(s.hashes):
                s.hist_hashes.append(s.hashes[i])
                continue
            prev = s.hist_hashes[i - 1] if i else None
            s.hist_hashes.append(m.prefix.extend_chain(
                prev, s.feed_slice(i * bs, bs)))
        return s.hist_hashes[j]

    def _publish_history_locked(self, m, s):
        """Publish each newly completed history block (a full block past
        the prompt's) under its prompt ++ out chain digest
        (``FLAGS_session_migration``).  A block publishes once all its
        positions are fed, so its content is final; a replica that ran a
        generation then holds its whole history chain, and a crash resume
        there re-feeds less than one block."""
        if m.prefix is None or s.handoff or not _flag("session_migration"):
            return
        bs = m.kv_config.block_size
        first = len(s.prompt) // bs        # prompt-only blocks: above
        done = s.n_fed // bs
        s.hist_published = max(s.hist_published, first)
        while s.hist_published < done:
            j = s.hist_published
            m.prefix.publish(s.blocks[j], self._hist_digest_locked(m, s, j))
            s.hist_published = j + 1

    def _admit_resume_locked(self, m, s):
        """Admission when ``replay_upto > len(prompt)`` (a resumed session
        or a preempted replay): match the history chain prompt ++ emitted
        tokens, then install the migrated tail block when every full block
        below it matched and its digest agrees.  Whatever is not matched
        is replayed; the tokens are the same either way."""
        from .migrate import tail_digest

        bs = m.kv_config.block_size
        pos = s.replay_upto - 1          # the last emitted token is re-fed
        nfull = pos // bs
        s.hashes = m.prefix.chain(s.prompt)
        digests = [self._hist_digest_locked(m, s, j) for j in range(nfull)]
        blocks = m.prefix.match_digests(digests)
        if blocks:
            s.blocks = list(blocks)
            s.table[:len(blocks)] = blocks
            s.n_fed = len(blocks) * bs
        s.published = min(len(blocks), len(s.hashes))
        s.hist_published = len(blocks)
        tail, s.resume_tail = s.resume_tail, None
        if tail is not None and len(blocks) == nfull and nfull * bs < pos:
            want = tail_digest(digests[-1] if digests else None,
                               s.feed_slice(nfull * bs, pos - nfull * bs))
            if tail.get("digest") != want \
                    or int(tail.get("valid", -1)) != pos - nfull * bs:
                # a stale or foreign tail is not trusted: replayed
                _tm.inc("kv_migrate_refused_total", reason="tail_mismatch")
            else:
                got = m.cache.allocator.alloc(1)
                if got is not None:
                    b = got[0]
                    try:
                        m.cache.import_block(b, tail["arrays"])
                    except (ValueError, RuntimeError):
                        m.cache.allocator.free([b])
                    else:
                        # private to the resumed sequence, never indexed
                        s.blocks.append(b)
                        s.table[nfull] = b
                        s.n_fed = pos
        s.cached_tokens = s.n_fed
        s.next_tok = s.feed_tok(s.n_fed)

    def _prefill_limit(self, s):
        """The last position this replica feeds from known history: the
        handoff boundary for a prefill-role sequence, else replay_upto."""
        return s.prefill_upto if s.handoff else s.replay_upto

    def _sweep_handoff_locked(self):
        """Finish the handoff sequences that reached their boundary: fire
        ``on_handoff`` while their blocks are still held, then free them
        and finish "handoff" (the decode half owns the client's reply)."""
        for s in list(self._active):
            if not s.handoff or s.n_fed < s.prefill_upto:
                continue
            m = self._model_of(s)
            self._active.remove(s)
            if self.on_handoff is not None:
                try:
                    self.on_handoff(m, s)
                except Exception:  # the hook never stops the loop
                    _log.exception("on_handoff failed")
            self._free_blocks(s)
            self._finish(s, InferReply("handoff"))
            _tm.inc("serving_handoff_total", model=m.name)

    def _plan_lanes_locked(self, chunk):
        """Lanes that run this step -> (participants, span_caps).  Without
        a prefill token budget, every active lane (up to the largest
        bucket) and no caps.  With a budget B, decode lanes always run and
        prefilling lanes join round-robin until their prefill spans (up to
        ``chunk`` tokens each: 1 plain, k+1 speculating) sum to B;
        ``span_caps`` maps id(seq) to its span this iteration."""
        max_lanes = max(self.buckets)
        budget = self.prefill_token_budget
        if budget <= 0:
            return self._active[:max_lanes], {}
        decode = [s for s in self._active if not s.in_prefill]
        prefill = [s for s in self._active if s.in_prefill]
        if prefill:
            r = self._rr_prefill % len(prefill)
            prefill = prefill[r:] + prefill[:r]
        chosen, caps, left = [], {}, budget
        for s in prefill:
            if left <= 0 or len(decode) + len(chosen) >= max_lanes:
                break
            span = min(chunk, self._prefill_limit(s) - s.n_fed, left)
            caps[id(s)] = span
            left -= span
            chosen.append(s)
        self._rr_prefill += max(len(chosen), 1)
        return (decode + chosen)[:max_lanes], caps

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
                self._run_boundary_calls_locked()
                if not self._running:
                    return
                self._expire_and_admit()
                if not self._active:
                    self._cond.wait(0.05)
                    continue
                if not checked:
                    continue    # work arrived after the check: check it
                step_ok = self._decode_step_locked()
                preempted, self._preempted = self._preempted, []
            if preempted and self.on_preempt is not None:
                try:
                    self.on_preempt(preempted)
                except Exception:  # the hook never stops the loop
                    _log.exception("on_preempt failed")
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
        # prefill-role sequences that reached their boundary (in the last
        # step, or at admission through a prefix hit)
        self._sweep_handoff_locked()
        if not self._active:
            return True
        if m.spec_k > 0:
            return self._spec_step_locked(m)
        participants, _caps = self._plan_lanes_locked(1)
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
                    torch.from_numpy(lens).to(dev),
                    m.cache.pools[2:] or None)     # int8: the scales
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
            # seal + publish any prompt block this write completed, then
            # any history block
            self._publish_prefix_locked(m, s)
            self._publish_history_locked(m, s)
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


    def _spec_step_locked(self, m):
        """One speculative iteration (self._cond held; released around the
        device work, as in ``_decode_step_locked``).  The draft proposes k
        tokens a generating lane through its own pool (one rollout), ONE
        bucketed (k+1)-column target step verifies them, the longest
        draft prefix matching the target's greedy chain is accepted, and
        the blocks reserved past the accepted frontier go back to both
        pools in the same iteration.  Prefill lanes ride the verify as a
        chunk of up to k+1 prompt tokens, auto-accepted and mirrored into
        the draft pool (tail only: positions a prefix-cache hit skipped
        stay unwritten there, which can only lower acceptance).  The
        draft then catches up (one ingest step): on those prompt chunks,
        and at position p + k after a full accept, which the rollout
        never wrote.

        Column layout is junk first: a lane with span < k+1 tokens puts
        them in the last columns and fills the leading ones with lens 0
        writes at its first position p, which the first real column
        overwrites before anything attends it, so a short lane writes
        nothing past its reservation."""
        k = m.spec_k
        width = k + 1
        participants, caps = self._plan_lanes_locked(width)
        plans = {}
        for s in participants:
            if s not in self._active:
                continue   # preempted by an earlier lane's allocation
            p = s.n_fed
            if s.in_prefill:
                span = caps.get(id(s),
                                min(width, self._prefill_limit(s) - p))
                spec = False
                draft_upto = p + span
            else:
                span = min(width, s.max_new - len(s.out))
                spec = span > 1         # the last token needs no proposal
                # the rollout writes up to p + k - 1 (clamped to the
                # sequence's end); a full accept ingests d_k at p + k
                draft_upto = min(p + k + 1, s.total) if spec else 0
            if self._ensure_capacity(s, p + span, draft_upto):
                plans[id(s)] = (span, spec)
        lanes = [s for s in participants
                 if s in self._active and id(s) in plans]
        if not lanes:
            return True
        bucket = self._bucket_for(len(lanes))
        tok = np.zeros((bucket, width), np.int32)
        pos = np.zeros((bucket, width), np.int32)
        lens = np.zeros((bucket, width), np.int32)
        tables = np.full((bucket, m.maxb), -1, np.int32)
        rtok = np.zeros(bucket, np.int32)
        rpos = np.zeros(bucket, np.int32)
        rlens = np.zeros(bucket, np.int32)
        rmax = np.zeros(bucket, np.int32)
        rtables = np.full((bucket, m.maxb), -1, np.int32)
        n_spec = 0
        for i, s in enumerate(lanes):
            span, spec = plans[id(s)]
            p = s.n_fed
            pad = width - span
            tables[i] = s.table
            pos[i, :pad] = p
            feed = s.feed_slice(p, span) if s.in_prefill else [s.next_tok]
            for j in range(span):
                pos[i, pad + j] = p + j
                lens[i, pad + j] = p + j + 1
            for j, t in enumerate(feed):
                tok[i, pad + j] = t
            if spec:
                n_spec += 1
                rtok[i] = s.next_tok
                rpos[i] = p
                rlens[i] = p + 1
                rmax[i] = s.total - 1
                rtables[i] = s.draft_table
        self._step_no += 1
        sspan = _tr.start_span(
            "serving.decode_step", model=m.name, bucket=bucket,
            lanes=len(lanes), step=self._step_no, speculative=True, k=k)
        for s in lanes:
            sspan.link(s.pending.span.context
                       if s.pending.span is not None else None)
        req_ids = [s.pending.req_id for s in lanes]
        dev = self.device

        def on_dev(a):
            return torch.from_numpy(a).to(dev)

        t0 = time.perf_counter()
        err = None
        props = None
        self.in_batch = True
        self._cond.release()
        try:
            with _tr.activate(sspan):
                if n_spec:
                    _tr.note("decode_step", model=m.name,
                             step=self._step_no, phase="draft",
                             req_ids=req_ids)
                    with _tr.span("serving.draft", lanes=n_spec, k=k):
                        m.rollouts += 1
                        props = m.draft.draft_rollout(
                            m.draft_cache.pools, on_dev(rtok), on_dev(rpos),
                            on_dev(rtables), on_dev(rlens), on_dev(rmax),
                            k).cpu().numpy()
                    for i, s in enumerate(lanes):
                        span, spec = plans[id(s)]
                        if spec:
                            tok[i, width - span + 1:] = props[i, :span - 1]
                _tr.note("decode_step", model=m.name, step=self._step_no,
                         phase="verify", req_ids=req_ids)
                with _tr.span("serving.verify", lanes=len(lanes),
                              width=width):
                    m.verifies += 1
                    nxt, _logits = m.decoder.paged_step_multi(
                        m.cache.pools, on_dev(tok), on_dev(pos),
                        on_dev(tables), on_dev(lens))
                    nxt = nxt.cpu().numpy()
        except Exception as e:  # the loop keeps serving; the lanes fail
            _log.exception("speculative step failed on %d lanes", len(lanes))
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
        n_generated = k_proposed = k_accepted = 0
        ingest = []    # (seq, start position, tokens): the draft's catch-up
        for i, s in enumerate(lanes):
            span, spec = plans[id(s)]
            p = s.n_fed
            pad = width - span
            accepted = 0
            if s.in_prefill:
                s.n_fed += span
                self._publish_prefix_locked(m, s)
                self._publish_history_locked(m, s)
                ingest.append((s, p, s.feed_slice(p, span)))
                if s.in_prefill:
                    s.next_tok = s.feed_tok(s.n_fed)
                    continue
                # the chunk reached the end of the known history: its last
                # column's argmax is the first new token
                emitted = [int(nxt[i, pad + span - 1])]
            else:
                # column j's argmax continues the chain only while
                # proposal j matched the argmax before it
                emitted = [int(nxt[i, pad])]
                while accepted < span - 1 and \
                        int(props[i, accepted]) == emitted[-1]:
                    emitted.append(int(nxt[i, pad + accepted + 1]))
                    accepted += 1
                if spec:
                    k_proposed += span - 1
                    k_accepted += accepted
                    _tm.observe("spec_acceptance",
                                accepted / float(span - 1), model=m.name)
                s.n_fed += len(emitted)
            done = False
            for t in emitted:
                s.out.append(t)
                s.token_times.append(t_tok)
                if s.t_first is None:
                    s.t_first = t_tok
                n_generated += 1
                done = len(s.out) >= s.max_new or t == s.eos_id
                if s.on_token is not None:
                    try:
                        s.on_token(s.pending.req_id, len(s.out) - 1, t,
                                   done, "ok")
                    except Exception:  # a client callback never stops it
                        _log.exception("on_token callback failed")
                if done:
                    break     # an EOS inside an accepted run ends it there
            # after the appends: an accept advances n_fed past tokens that
            # were only in ``emitted``, and the chain digest reads them
            # from prompt ++ out
            self._publish_history_locked(m, s)
            if done:
                self._active.remove(s)
                self._free_blocks(s)   # same-step free, both pools
                self._finish(s, InferReply("ok"))
                _tm.observe("serving_latency_ms",
                            s.pending.reply.latency_ms, model=m.name)
                continue
            s.next_tok = emitted[-1]
            if accepted == k:
                # a full accept: the rollout never wrote position p + k,
                # whose token is d_k (the target's g_k)
                ingest.append((s, p + k, [int(props[i, k - 1])]))
        # rollback: every block past the accepted frontier returns to its
        # pool now; the context lengths mask what it held
        rolled = 0
        for s in lanes:
            if s not in self._active:
                continue
            rolled += m.cache.trim_table(s.table, s.blocks, s.n_fed)
            rolled += m.draft_cache.trim_table(s.draft_table, s.draft_blocks,
                                               s.n_fed)
        if rolled:
            _tm.inc("spec_blocks_rolled_back_total", rolled, model=m.name)
        ingest = [(s, q, t) for (s, q, t) in ingest if s in self._active]
        if ingest:
            itok = np.zeros((bucket, width), np.int32)
            ipos = np.zeros((bucket, width), np.int32)
            ilens = np.zeros((bucket, width), np.int32)
            itables = np.full((bucket, m.maxb), -1, np.int32)
            for r, (s, q, toks) in enumerate(ingest):
                ipad = width - len(toks)
                itables[r] = s.draft_table
                ipos[r, :ipad] = q
                for j, t in enumerate(toks):
                    ipos[r, ipad + j] = q + j
                    ilens[r, ipad + j] = q + j + 1
                    itok[r, ipad + j] = t
            self.in_batch = True
            self._cond.release()
            try:
                with _tr.activate(sspan):
                    _tr.note("decode_step", model=m.name,
                             step=self._step_no, phase="draft",
                             ingest=len(ingest))
                    with _tr.span("serving.draft_ingest",
                                  lanes=len(ingest)):
                        m.ingests += 1
                        m.draft.paged_step_multi(
                            m.draft_cache.pools, on_dev(itok), on_dev(ipos),
                            on_dev(itables), on_dev(ilens))
            except Exception:
                # a stale draft pool only costs acceptance: the verify
                # guards every token
                _log.exception("draft ingest failed on %d lanes",
                               len(ingest))
                _tm.inc("spec_ingest_errors_total", model=m.name)
            finally:
                self._cond.acquire()
                self.in_batch = False
        if n_spec:
            _tm.inc("spec_tokens_proposed_total", k_proposed, model=m.name)
            _tm.inc("spec_tokens_accepted_total", k_accepted, model=m.name)
        if n_generated:
            _tm.inc("serving_tokens_generated_total", n_generated,
                    model=m.name)
        _tm.inc("serving_decode_steps_total", model=m.name)
        _tm.observe("decode_batch_occupancy", len(lanes) / float(bucket),
                    model=m.name)
        sspan.annotate(generated=n_generated, ms=round(ms, 3),
                       k_proposed=k_proposed, k_accepted=k_accepted).end()
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

def parse_tier_weights(spec=None):
    """\"paid:1.0,free:0.45\" (None reads ``FLAGS_serving_tier_weights``)
    -> {tier: weight}; weights in (0, 1]."""
    if spec is None:
        spec = _flag("serving_tier_weights")
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
    __slots__ = ("feeds", "rows", "t_dispatch")

    def __init__(self, model, tenant, feeds, deadline_ms, req_id, callback,
                 tier="default", weight=1.0, traceparent=None):
        super().__init__(model, deadline_ms, req_id, callback,
                         traceparent=traceparent, tenant=tenant, tier=tier,
                         weight=weight)
        self.feeds = feeds
        self.rows = 0
        self.t_dispatch = None


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
    ``device`` (default ``cuda``; the CPU only when asked).  An argument
    left None reads its flag, as the reference's engine does:
    ``FLAGS_serving_buckets`` ("1,4,16,64"), ``FLAGS_serving_max_queue``
    (256), ``FLAGS_serving_deadline_ms`` (2000),
    ``FLAGS_serving_batch_window_ms`` (2) and
    ``FLAGS_serving_tier_weights``."""

    def __init__(self, buckets=None, max_queue=None, deadline_ms=None,
                 batch_window_ms=None, tier_weights=None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.buckets = parse_buckets(buckets)
        self.max_queue = int(_or_flag(max_queue, "serving_max_queue"))
        self.default_deadline_ms = float(_or_flag(deadline_ms,
                                                  "serving_deadline_ms"))
        self.batch_window_ms = float(_or_flag(batch_window_ms,
                                              "serving_batch_window_ms"))
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
