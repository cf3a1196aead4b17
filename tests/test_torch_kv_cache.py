"""Paged KV cache of the PyTorch port (paddle_tpu_torch/serving/kv_cache.py)
held against the JAX package's (paddle_tpu/serving/kv_cache.py): the same
scripted allocator and prefix-index operations must give the same results
step by step, the hash chains must be the same digests, and sizing must
plan the same pools.  Host logic only: exact equality throughout."""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.serving import kv_cache as tkv


def _cfg(mod, **kw):
    base = dict(layers=2, heads=2, head_dim=8, block_size=4, num_blocks=8)
    base.update(kw)
    return mod.KVCacheConfig(**base)


# -- scripted parity: the same operations on both allocators -----------------

SCRIPTS = {
    "roundtrip": (8, [("alloc", 3), ("free", 0), ("alloc", 2),
                      ("alloc", 9), ("alloc", 0)]),
    "oom_all_or_nothing": (4, [("alloc", 3), ("alloc", 2), ("free", 0),
                               ("alloc", 2)]),
    "share_and_seal": (6, [("alloc", 2), ("incref", 0, 0), ("seal", 0, 0),
                           ("free", 0), ("alloc", 3), ("incref", 0, 1),
                           ("free", 1), ("free", 0)]),
    "evict_lru": (5, [("alloc", 4), ("seal", 0, 0), ("seal", 0, 1),
                      ("seal", 0, 2), ("free", 0), ("alloc", 2),
                      ("incref", 0, 2), ("alloc", 1), ("alloc", 1)]),
}


def _run(mod, nblocks, script):
    a = mod.BlockAllocator(nblocks, reserve=1)
    evicted = []
    a.on_evict = lambda b, tag: evicted.append((b, tag))
    grants, trace = [], []
    for op in script:
        if op[0] == "alloc":
            got = a.alloc(op[1])
            grants.append(got)
            trace.append(("alloc", got))
        elif op[0] == "free":
            a.free(grants[op[1]])
            trace.append(("free",))
        elif op[0] == "incref":
            trace.append(("incref", a.incref(grants[op[1]][op[2]])))
        elif op[0] == "seal":
            a.seal(grants[op[1]][op[2]], "t%d" % op[2])
            trace.append(("seal",))
        trace.append(a.stats())
    return trace, evicted


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_allocator_scripts_match_reference(name):
    nblocks, script = SCRIPTS[name]
    assert _run(tkv, nblocks, script) == _run(jkv, nblocks, script)


def test_allocator_refusals_match_reference():
    for mod in (jkv, tkv):
        a = mod.BlockAllocator(4, reserve=1)
        got = a.alloc(2)
        a.free(got)
        with pytest.raises(ValueError):
            a.free(got)                 # double free
        with pytest.raises(ValueError):
            a.free([99])                # foreign id
        with pytest.raises(ValueError):
            a.seal(99, "x")
        assert not a.incref(got[0])     # freed unsealed: gone
        with pytest.raises(ValueError):
            mod.BlockAllocator(2, reserve=2)


def test_lifo_reuse_and_reserved_scratch():
    a = tkv.BlockAllocator(8, reserve=1)
    first = a.alloc(7)
    assert 0 not in first
    a.free(first[:2])
    assert a.alloc(2)[0] == first[1]    # most recently freed first


# -- prefix index ------------------------------------------------------------


@pytest.mark.parametrize("namespace", ["m", "gpt2-small"])
def test_hash_chain_is_the_reference_digest(namespace):
    toks = list(np.random.RandomState(0).randint(0, 50257, 37))
    jc = jkv.PrefixCache(jkv.BlockAllocator(8, reserve=1), 4, namespace)
    tc = tkv.PrefixCache(tkv.BlockAllocator(8, reserve=1), 4, namespace)
    assert tc.chain(toks) == jc.chain(toks)
    assert len(tc.chain(toks)) == 9             # full blocks only


def test_match_publish_revive_matches_reference():
    def run(mod):
        a = mod.BlockAllocator(8, reserve=1)
        pc = mod.PrefixCache(a, block_size=4, namespace="m")
        prompt = list(range(10))
        out = [pc.match(prompt)[:2]]
        owned = a.alloc(3)
        _, _, h = pc.match(prompt)
        out.append((pc.publish(owned[0], h[0]), pc.publish(owned[1], h[1]),
                    pc.publish(owned[2], h[1])))   # first publisher wins
        a.free(owned)
        out.append(a.stats())
        got, cached, _ = pc.match(prompt)
        out.append((got, cached, a.refcount(got[0]), len(pc)))
        # a full-prompt match stops one block short (len - 1 cap)
        got2, cached2, _ = pc.match(list(range(8)))
        out.append((got2, cached2))
        a.free(got + got2)
        out.append(a.stats())
        return out

    assert run(tkv) == run(jkv)


def test_eviction_deindexes_and_match_misses():
    a = tkv.BlockAllocator(4, reserve=1)            # capacity 3
    pc = tkv.PrefixCache(a, block_size=4, namespace="m")
    prompt = [1, 2, 3, 4, 9]
    h = pc.chain(prompt)
    (b,) = a.alloc(1)
    pc.publish(b, h[0])
    a.free([b])
    assert len(pc) == 1 and a.num_evictable == 1
    a.alloc(3)                      # pressure reclaims the parked block
    assert len(pc) == 0
    assert pc.match(prompt)[:2] == ([], 0)


# -- sizing ------------------------------------------------------------------


def test_block_bytes_matches_reference():
    for kw in ({}, {"layers": 12, "heads": 12, "head_dim": 64,
                    "block_size": 16}):
        assert tkv.block_bytes(_cfg(tkv, **kw)) == \
            jkv.block_bytes(_cfg(jkv, **kw))
    # GPT-2 small: 2 * 12 layers * 16 positions * 768 * 4 B per block
    assert tkv.block_bytes(_cfg(tkv, layers=12, heads=12, head_dim=64,
                                block_size=16)) == 1179648


@pytest.mark.parametrize("requested,budget,resident", [
    (17, 0, 0), (0, 0, 0), (100, 11, 1), (0, 6, 0), (5, 40, 3)])
def test_plan_num_blocks_matches_reference(requested, budget, resident):
    per = tkv.block_bytes(_cfg(tkv))
    kw = dict(model_resident_bytes=resident * per, requested=requested,
              budget=budget * per + (1 if budget else 0))
    assert tkv.plan_num_blocks(_cfg(tkv), **kw) == \
        jkv.plan_num_blocks(_cfg(jkv), **kw)


def test_plan_raises_when_budget_cannot_hold_two_blocks():
    cfg = _cfg(tkv)
    with pytest.raises(ValueError, match="needs >= 2"):
        tkv.plan_num_blocks(cfg, requested=8, budget=tkv.block_bytes(cfg))
    assert tkv.plan_num_blocks(cfg) == (tkv.DEFAULT_BLOCKS, False)


# -- the device pools --------------------------------------------------------


def test_cache_pools_on_the_cpu_when_asked():
    c = tkv.PagedKVCache(_cfg(tkv), device="cpu")
    assert c.allocator.reserve == 1 and c.allocator.capacity == 7
    assert c.k.shape == (2, 8, 4, 2, 8) and c.k.dtype == torch.float32
    assert c.v.shape == c.k.shape and not c.k.any()
    assert c.nbytes == tkv.block_bytes(c.config) * 8
    assert [c.blocks_for_tokens(n) for n in (1, 4, 5)] == [1, 1, 2]


def test_cache_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkv.PagedKVCache(_cfg(tkv))


def test_ensure_table_matches_reference():
    def run(mod, pool):
        table = np.full(8, -1, np.int32)
        blocks = []
        out = [pool.ensure_table(table, blocks, 5), list(table),
               pool.ensure_table(table, blocks, 8),
               pool.ensure_table(table, blocks, 32), list(table),
               pool.allocator.stats()]
        return out

    t = run(tkv, tkv.PagedKVCache(_cfg(tkv), device="cpu"))
    j = run(jkv, jkv.PagedKVCache(_cfg(jkv)))
    assert t == j and t[0] and not t[3]
