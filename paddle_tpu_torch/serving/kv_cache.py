"""Paged KV cache for autoregressive decode serving.

Counterpart of ``paddle_tpu/serving/kv_cache.py``.  The engine owns a
pool of fixed-size KV blocks (``[layers, num_blocks, block_size, heads,
head_dim]`` tensors on the device) and hands each admitted sequence a
*block table*: the physical blocks holding its history, grown one block
per ``block_size`` tokens.  Sequences of any length present the decode
step with the same shapes (token ids, tables padded to ``max_seq //
block_size`` slots, context lengths), and a finished sequence returns its
blocks the same step it finishes.

``BlockAllocator`` is the refcounted host-side free list (LIFO reuse,
all-or-nothing ``alloc``); a sealed block whose refcount reaches zero
parks in an LRU *evictable* pool, still revivable until ``alloc``
reclaims it.  ``PrefixCache`` is the content-addressed index over sealed
full blocks (hash chain ``h_i = sha(h_{i-1}, block_token_ids)``), over a
prompt or, extended block by block (``extend_chain``), over a decode
history; ``match_digests`` revives a precomputed chain (a resumed
session's) and ``forget`` un-indexes and truly frees an adopted block.
``PagedKVCache`` owns the K and V pools: f32, or int8 with f32 max-abs
scales per (block, position, head) (``KVCacheConfig(dtype="int8")``,
``quantize_kv``).  The JAX reference donates the pools through its
jitted step and gets new arrays back; here the decode step writes into
them in place with ``index_put_``.  ``ensure_table`` and ``trim_table``
grow a table by several blocks at once and roll it back, which is what
speculative decode reserves and returns every iteration.
``export_block`` and ``import_block`` copy one block of every pool off
the device and back, in the reference's carry order and host format (the
unit that ``serving/disagg.py`` and ``serving/migrate.py`` move between
replicas of either package).
"""

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..core import telemetry as _tm
from ..device import resolve_device
from ..flags import flag as _flag

__all__ = ["KVCacheConfig", "BlockAllocator", "PagedKVCache", "PrefixCache",
           "plan_num_blocks", "block_bytes", "quantize_kv", "dequantize_kv",
           "DEFAULT_BLOCKS"]

# pool size when neither a request nor a budget pins one
DEFAULT_BLOCKS = 64


class KVCacheConfig:
    """Static cache geometry; hidden = heads * head_dim per layer.
    ``dtype`` is the pools' residency, "f32" or "int8"."""

    __slots__ = ("layers", "heads", "head_dim", "block_size", "num_blocks",
                 "dtype")

    def __init__(self, layers, heads, head_dim, block_size, num_blocks,
                 dtype="f32"):
        if dtype not in ("f32", "int8"):
            raise ValueError("kv_cache dtype must be f32|int8: %r" % dtype)
        if block_size <= 0 or num_blocks <= 1:
            raise ValueError("need block_size > 0 and num_blocks > 1 "
                             "(block 0 is the idle-lane scratch)")
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.dtype = dtype


def block_bytes(config):
    """Device bytes ONE block costs across all layers: K + V, and for int8
    the payload plus the f32 scale of each (position, head)."""
    per_tok = config.heads * config.head_dim
    if config.dtype == "int8":
        tok = per_tok + config.heads * 4
    else:
        tok = per_tok * 4
    return 2 * config.layers * config.block_size * tok


def plan_num_blocks(config, model_resident_bytes=0, requested=None,
                    budget=None):
    """Budget-gated pool sizing -> (num_blocks, capped).

    ``requested`` (None reads ``FLAGS_kv_cache_blocks``; <= 0 = auto) asks
    for a pool size; ``budget`` (None reads ``FLAGS_hbm_budget_bytes``;
    device bytes, 0 = no gate) caps it at what fits beside the model's
    resident bytes.  A budget too small for a 2-block pool raises, naming
    the flag."""
    if requested is None:
        requested = _flag("kv_cache_blocks")
    if budget is None:
        budget = _flag("hbm_budget_bytes")
    requested = int(requested or 0)
    budget = int(budget or 0)
    per = block_bytes(config)
    if budget > 0:
        fit = int((budget - int(model_resident_bytes)) // per)
        if fit < 2:
            raise ValueError(
                "FLAGS_hbm_budget_bytes=%d leaves room for %d KV block(s) "
                "of %d bytes beside %d model-resident bytes; the decode "
                "cache needs >= 2 (shrink the model, raise the budget, or "
                "set FLAGS_kv_cache_dtype=int8)"
                % (budget, max(fit, 0), per, model_resident_bytes))
        if requested > 0:
            return min(requested, fit), fit < requested
        return fit, False
    return (requested if requested > 0 else DEFAULT_BLOCKS), False


class BlockAllocator:
    """Refcounted host-side free list over physical block ids.

    ``reserve`` low ids never circulate (block 0 is the idle-lane write
    scratch).  ``alloc`` is all-or-nothing.  ``incref`` shares a block
    (prefix-cache hits), ``free`` drops one reference, and a ``seal``-ed
    block released at zero refs parks in the LRU evictable pool instead
    of the free list; ``alloc`` reclaims evictable blocks LRU-first once
    the free list runs dry, calling ``on_evict(block, tag)`` afterwards
    with the allocator lock released.  ``reclaimable`` (free + evictable)
    is what admission budgets against."""

    def __init__(self, num_blocks, reserve=0):
        if num_blocks <= reserve:
            raise ValueError("num_blocks %d <= reserve %d"
                             % (num_blocks, reserve))
        self.num_blocks = int(num_blocks)
        self.reserve = int(reserve)
        # LIFO: the most recently freed block is the next handed out
        self._free = list(range(num_blocks - 1, reserve - 1, -1))
        self._ref = {}                   # id -> refcount >= 1 (in use)
        self._sealed = {}                # id -> content tag (in use)
        self._evictable = OrderedDict()  # id -> tag; zero-ref, LRU order
        self.on_evict = None
        self._lock = threading.Lock()
        self.high_water = 0

    @property
    def capacity(self):
        return self.num_blocks - self.reserve

    @property
    def num_free(self):
        with self._lock:
            return len(self._free)

    @property
    def num_evictable(self):
        with self._lock:
            return len(self._evictable)

    @property
    def reclaimable(self):
        with self._lock:
            return len(self._free) + len(self._evictable)

    @property
    def in_use(self):
        with self._lock:
            return len(self._ref)

    def refcount(self, block):
        with self._lock:
            return self._ref.get(block, 0)

    def alloc(self, n):
        """n blocks or None (nothing is taken).  Free list first, then
        evictable blocks LRU-first."""
        if n <= 0:
            return []
        evicted = []
        with self._lock:
            if n > len(self._free) + len(self._evictable):
                return None
            got = []
            while len(got) < n and self._free:
                got.append(self._free.pop())
            while len(got) < n:
                b, tag = self._evictable.popitem(last=False)
                evicted.append((b, tag))
                got.append(b)
            for b in got:
                self._ref[b] = 1
            self._note_high_water_locked()
            self._gauges_locked()
            cb = self.on_evict
        # outside the allocator lock: the index callback takes its own lock
        if cb is not None:
            for b, tag in evicted:
                cb(b, tag)
        return got

    def incref(self, block):
        """Take another share of ``block``: True if it was in use or
        parked evictable (revived at refcount 1), False if reclaimed."""
        with self._lock:
            if block in self._ref:
                self._ref[block] += 1
                return True
            tag = self._evictable.pop(block, None)
            if tag is None:
                return False
            self._ref[block] = 1
            self._sealed[block] = tag
            self._note_high_water_locked()
            self._gauges_locked()
            return True

    def seal(self, block, tag):
        """Mark an in-use block's content complete under ``tag``: at zero
        refs it parks evictable instead of returning to the free list."""
        with self._lock:
            if block not in self._ref:
                raise ValueError("seal of unallocated block %r" % (block,))
            self._sealed[block] = tag

    def free(self, blocks):
        """Drop one reference per block.  A double free or a foreign id
        raises."""
        blocks = list(blocks)
        with self._lock:
            for b in blocks:
                if b not in self._ref:
                    raise ValueError("free of unallocated block %r" % (b,))
            for b in blocks:
                self._ref[b] -= 1
                if self._ref[b] > 0:
                    continue
                del self._ref[b]
                tag = self._sealed.pop(b, None)
                if tag is not None:
                    self._evictable[b] = tag
                else:
                    self._free.append(b)
            self._gauges_locked()

    def discard_evictable(self, block):
        """Truly free a zero-ref evictable block (back to the free list,
        its content dropped): how a decode replica returns the blocks it
        adopted for a request that died on the prefill half.  False when
        the block is not evictable (reclaimed already, or revived by a
        sequence that frees it at its finish)."""
        with self._lock:
            if block not in self._evictable:
                return False
            del self._evictable[block]
            self._free.append(block)
            self._gauges_locked()
        _tm.inc("kv_block_discard_total")
        return True

    def _gauges_locked(self):
        # the reference's pool gauges, republished with __metrics__
        _tm.set_gauge("kv_blocks_in_use", len(self._ref))
        _tm.set_gauge("kv_blocks_evictable", len(self._evictable))

    def _note_high_water_locked(self):
        # evictable blocks still occupy pool slots
        self.high_water = max(self.high_water,
                              len(self._ref) + len(self._evictable))

    def stats(self):
        with self._lock:
            return {"capacity": self.capacity, "free": len(self._free),
                    "in_use": len(self._ref),
                    "evictable": len(self._evictable),
                    "reclaimable": len(self._free) + len(self._evictable),
                    "high_water": self.high_water}


class PrefixCache:
    """Content-addressed index of sealed full-prompt KV blocks.

    ``match`` revives the longest indexed prefix of a prompt, taking one
    reference per block for the caller, capped at ``len(prompt) - 1``
    tokens: prefill always computes at least one tail token and every
    write lands in a private tail block, so shared blocks are read-only.
    ``publish`` is first-publisher-wins.  Lock order: this index's lock,
    then the allocator's, never the reverse."""

    def __init__(self, allocator, block_size, namespace=""):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.namespace = str(namespace)
        self.lookup_tokens = 0           # prompt tokens looked up, and
        self.hit_tokens = 0              # those served from the index
        self._seed = hashlib.sha256(
            ("kvprefix:%s" % namespace).encode()).digest()
        self._index = {}                 # hex digest -> physical block id
        self._lock = threading.Lock()
        allocator.on_evict = self._on_evict

    def chain(self, token_ids):
        """Hash chain over the full blocks of ``token_ids`` -> hex
        digests, one per full block."""
        bs = self.block_size
        out = []
        h = self._seed
        for j in range(len(token_ids) // bs):
            d = hashlib.sha256(h)
            d.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                              for t in token_ids[j * bs:(j + 1) * bs]))
            h = d.digest()
            out.append(h.hex())
        return out

    def extend_chain(self, prev_hex, block_tokens):
        """One chain step past ``prev_hex`` (None: the chain's seed) over
        the next block's token ids -> its hex digest; a decoding sequence
        extends its prompt's chain over generated tokens this way."""
        h = self._seed if prev_hex is None else bytes.fromhex(prev_hex)
        d = hashlib.sha256(h)
        d.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                          for t in block_tokens))
        return d.hexdigest()

    def match_digests(self, digests):
        """Longest indexed prefix of a precomputed chain -> its blocks,
        one reference taken per block.  A resume knows its whole history
        chain and needs no one-token cap: its next fed token is decided."""
        blocks = []
        with self._lock:
            for d in digests:
                b = self._index.get(d)
                if b is None:
                    break
                if not self.allocator.incref(b):
                    self._index.pop(d, None)
                    break
                blocks.append(b)
        return blocks

    def match(self, prompt_ids):
        """Longest cached prefix -> ``(blocks, cached_tokens, hashes)``;
        ``blocks`` arrive with one reference taken per block."""
        hashes = self.chain(prompt_ids)
        max_blocks = max(0, (len(prompt_ids) - 1) // self.block_size)
        blocks = []
        with self._lock:
            for j in range(min(len(hashes), max_blocks)):
                b = self._index.get(hashes[j])
                if b is None:
                    break
                if not self.allocator.incref(b):
                    # reclaimed before the callback ran: forget and stop
                    self._index.pop(hashes[j], None)
                    break
                blocks.append(b)
        cached = len(blocks) * self.block_size
        with self._lock:
            self.lookup_tokens += len(prompt_ids)
            self.hit_tokens += cached
        # the reference's counters, and their namespace-labelled twins
        # that the server's 1 s republish windows into a hit rate
        _tm.inc("prefix_cache_lookup_tokens_total", len(prompt_ids))
        _tm.inc("prefix_cache_ns_lookup_tokens_total", len(prompt_ids),
                namespace=self.namespace)
        if cached:
            _tm.inc("prefix_cache_hit_tokens_total", cached)
            _tm.inc("prefix_cache_ns_hit_tokens_total", cached,
                    namespace=self.namespace)
        return blocks, cached, hashes

    def hit_rate(self):
        """Hit tokens over looked-up tokens so far (0.0 before any)."""
        with self._lock:
            if self.lookup_tokens <= 0:
                return 0.0
            return self.hit_tokens / float(self.lookup_tokens)

    def lookup(self, digest):
        """The block indexed under ``digest``, or None; takes no
        reference."""
        with self._lock:
            return self._index.get(digest)

    def publish(self, block, digest):
        """Index a freshly filled full-prompt ``block`` under ``digest``;
        a duplicate digest leaves the block private and returns False."""
        with self._lock:
            if digest in self._index:
                return False
            self.allocator.seal(block, digest)
            self._index[digest] = block
            return True

    def forget(self, digest):
        """Un-index ``digest`` and truly free its block when it sits
        zero-ref evictable (a block a live sequence revived only loses
        its entry; its owner frees it).  True when the entry existed."""
        with self._lock:
            b = self._index.pop(digest, None)
        if b is None:
            return False
        # outside this lock: index before allocator, as on_evict
        self.allocator.discard_evictable(b)
        return True

    def _on_evict(self, block, tag):
        with self._lock:
            if self._index.get(tag) == block:
                del self._index[tag]

    def __len__(self):
        with self._lock:
            return len(self._index)


def quantize_kv(x):
    """f32 [..., H, D] -> (int8 payload, f32 per-[..., H] max-abs scale):
    symmetric, round half to even (``torch.round``, as ``jnp.round``),
    clipped to [-127, 127]; an all-zero row takes the scale 1.0 for the
    division and stores 0."""
    scale = x.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127) \
        .to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_kv(q, scale):
    return q.to(torch.float32) * scale[..., None]


class PagedKVCache:
    """The K and V pools, ``[layers, num_blocks, block_size, heads,
    head_dim]`` on ``device``: f32, or int8 beside f32 ``k_scale`` and
    ``v_scale`` ``[layers, num_blocks, block_size, heads]``.  Block 0 is
    reserved: idle lanes of a partly full bucket point their table at it,
    so their (masked, discarded) writes never touch a sequence's history.
    The decode step updates the pools in place."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(config.num_blocks, reserve=1)
        shape = (config.layers, config.num_blocks, config.block_size,
                 config.heads, config.head_dim)
        int8 = config.dtype == "int8"
        dt = torch.int8 if int8 else torch.float32
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.k_scale = self.v_scale = None
        if int8:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)

    @property
    def pools(self):
        """The step's pool tensors in the reference's carry order: (k, v),
        or (k, v, k_scale, v_scale) for int8."""
        if self.k_scale is None:
            return self.k, self.v
        return self.k, self.v, self.k_scale, self.v_scale

    @property
    def nbytes(self):
        return block_bytes(self.config) * self.config.num_blocks

    def blocks_for_tokens(self, n_tokens):
        """How many blocks a sequence of n_tokens needs."""
        bs = self.config.block_size
        return max(1, -(-int(n_tokens) // bs))

    def export_block(self, block):
        """Host copies (numpy) of one block of every pool, in the
        reference's carry order: ``[k, v]`` ``[L, bs, H, D]`` f32, or
        ``[k, v, k_scale, v_scale]`` for int8 (scales ``[L, bs, H]``).
        On the card the copy waits for the step that wrote the block."""
        return [np.ascontiguousarray(
            p[:, block].to("cpu", copy=True).numpy()) for p in self.pools]

    def import_block(self, block, arrays):
        """Write transferred ``arrays`` (``export_block``'s format, from
        either package) into physical ``block``.  The caller holds the
        engine between steps and owns the block.  A wrong arity, shape or
        dtype raises: a block cut for another geometry would corrupt every
        sequence that later matches its digest."""
        pools = self.pools
        if len(arrays) != len(pools):
            raise ValueError(
                "kv import arity mismatch: %d arrays for a %s-dtype "
                "carry of %d" % (len(arrays), self.config.dtype, len(pools)))
        host = []
        for p, a in zip(pools, arrays):
            a = np.asarray(a)
            want_shape = tuple(p.shape[:1] + p.shape[2:])
            want_dtype = np.dtype(str(p.dtype).replace("torch.", ""))
            if tuple(a.shape) != want_shape or a.dtype != want_dtype:
                raise ValueError(
                    "kv import geometry mismatch: got %s%s, carry wants "
                    "%s%s (block_size/heads/head_dim/dtype must agree "
                    "across the disaggregated pair)"
                    % (a.dtype, tuple(a.shape), want_dtype, want_shape))
            host.append(torch.from_numpy(np.require(a, requirements="CW")))
        # payload and scales together, or nothing
        for p, t in zip(pools, host):
            p[:, block].copy_(t)

    def ensure_table(self, table, blocks, upto_tokens):
        """Grow a sequence's block table to cover positions
        ``[0, upto_tokens)`` with one all-or-nothing allocation: True when
        covered, False (nothing taken) when the pool cannot."""
        need = self.blocks_for_tokens(upto_tokens)
        have = len(blocks)
        if need <= have:
            return True
        got = self.allocator.alloc(need - have)
        if got is None:
            return False
        table[have:have + len(got)] = got
        blocks.extend(got)
        return True

    def trim_table(self, table, blocks, upto_tokens):
        """Rollback: free every block past the one holding position
        ``upto_tokens - 1`` and clear its table slot; the context length
        masks what the freed blocks held.  Returns the blocks freed."""
        keep = self.blocks_for_tokens(upto_tokens) if upto_tokens > 0 else 0
        if len(blocks) <= keep:
            return 0
        extra = blocks[keep:]
        del blocks[keep:]
        table[keep:keep + len(extra)] = -1
        self.allocator.free(extra)
        return len(extra)
