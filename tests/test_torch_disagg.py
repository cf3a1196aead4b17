"""Disaggregated prefill and decode on the port (paddle_tpu_torch/serving/
disagg.py, the DecodeEngine's handoff and ``adopt_kv_block``, the
server's prefill and decode roles, the client's ``__pair__`` walk,
``tools/torch_serve.py --roles``), held against the JAX package on the
CPU at the reference tests' toy widths (vocab 31, 2 layers, 2 heads x 8,
blocks of 4).

* ``PagedKVCache.export_block`` / ``import_block`` round-trip f32 and int8
  blocks between the two packages bitwise, and refuse a geometry, arity
  or dtype mismatch in both.
* The reference's disaggregated cases (tests/test_disagg_serving.py:
  221-533) posed on the port: a pair's tokens are bitwise the reference's
  ``unpaged_generate`` (an int8 pair's the port's int8 monolith's), its
  reply carries both halves' phases, the decode half prefix-matches the
  adopted blocks, a warm peer is skipped, and both pools end empty; the
  monolith fallback without a peer; a decode half killed mid-stream; the
  orphan janitor; a position regression refused; the int8 frames within
  0.55x the f32 ones.  At one lane bucket the adopted blocks are bitwise
  the blocks the port's monolith computes (across packages, within
  1e-6).
* Across packages, in process: a reference prefill replica feeds a port
  decode replica, and a port prefill replica a reference decode one; both
  give the reference's tokens with the blocks counted "adopted".
* Two ``tools/torch_serve.py --device cpu --roles prefill,decode``
  replicas serve the demo decoder with the reference's tokens, and their
  ``__metrics__`` count the handoff.

Every wait is bounded, and every server and child process is stopped in
``finally``.
"""

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from dist_utils import free_ports
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ServingServer as JServer
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.native.rpc import RpcClient
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      ServingClient, ServingEngine,
                                      ServingServer, codec,
                                      init_decoder_params)
from paddle_tpu_torch.serving import kv_cache as tkv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SERVE = os.path.join(ROOT, "tools", "torch_serve.py")
CFG = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
PARAMS = init_decoder_params(CFG, seed=7)
JCFG = jdm.DecoderConfig(**CFG.to_dict())
BS = 4
LONG = 30000.0
ATOL_POOL = 1e-6


@functools.lru_cache(maxsize=None)
def _unpaged(prompt, max_new):
    """The reference's greedy tokens for ``prompt`` (a tuple)."""
    return np.asarray(jdm.unpaged_generate(JCFG, PARAMS, list(prompt),
                                           max_new), np.int32)


@pytest.fixture()
def telemetry_on():
    ttm.reset()
    set_flags({"FLAGS_telemetry": True})
    yield
    set_flags({"FLAGS_telemetry": False})
    ttm.reset()


def _ctr(name, **labels):
    """One port counter summed over the label sets that hold ``labels``."""
    out = 0.0
    for key, v in ttm.snapshot()["counters"].items():
        if key.split("{")[0] == name and all(
                "%s=%s" % kv in key for kv in labels.items()):
            out += v
    return out


def _ep(srv):
    return "127.0.0.1:%d" % srv.port


def _wait_until(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def _engine(dtype="f32", bs=BS, buckets="2,4", kv_blocks=64):
    e = DecodeEngine(buckets=buckets, block_size=bs, deadline_ms=LONG,
                     kv_dtype=dtype, device="cpu")
    e.add_model("toy", (CFG, PARAMS), kv_blocks=kv_blocks)
    return e


def _in_use(e):
    return e._models["toy"].cache.allocator.in_use


@contextlib.contextmanager
def _pair(dtype="f32", bs=BS, buckets="2,4"):
    """A prefill and a decode ServingServer of the port, paired by the
    static decode_peers -> (prefill server, decode server, client)."""
    ep_, ed = _engine(dtype, bs, buckets), _engine(dtype, bs, buckets)
    sd = ServingServer(ServingEngine(device="cpu"), port=0, decode_engine=ed,
                       role="decode").start()
    sp = None
    try:
        sp = ServingServer(ServingEngine(device="cpu"), port=0,
                           decode_engine=ep_, role="prefill",
                           decode_peers=[_ep(sd)]).start()
        yield sp, sd, ServingClient(endpoints=[_ep(sp), _ep(sd)],
                                    roles=["prefill", "decode"])
    finally:
        if sp is not None:
            sp.shutdown()
        sd.shutdown()


@contextlib.contextmanager
def _reference_flags(**kv):
    kv = {"FLAGS_" + k: v for k, v in kv.items()}
    old = fluid.get_flags(list(kv))
    fluid.set_flags(kv)
    try:
        yield
    finally:
        fluid.set_flags(old)


def _reference_engine():
    with _reference_flags(kv_block_size=BS, kv_cache_dtype="f32"):
        je = JDecodeEngine(buckets="2", deadline_ms=LONG)
        je.add_model("toy", (JCFG, PARAMS), kv_blocks=64)
    return je


# -- one block between the packages -------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_blocks_cross_between_the_packages(dtype):
    """The port's export is the reference's import format and the other
    way round, bitwise; an arity, shape or dtype mismatch raises in
    both."""
    rng = np.random.RandomState(3)
    t = tkv.PagedKVCache(tkv.KVCacheConfig(2, 2, 8, BS, 6, dtype=dtype),
                         device="cpu")
    for p in t.pools:
        if p.dtype == torch.int8:
            p.copy_(torch.from_numpy(rng.randint(-127, 128, p.shape)
                                     .astype(np.int8)))
        else:
            p.copy_(torch.from_numpy(rng.rand(*p.shape).astype(np.float32)))
    j = jkv.PagedKVCache(jkv.KVCacheConfig(2, 2, 8, BS, 6, dtype=dtype))
    sent = t.export_block(3)
    want = [(2, BS, 2, 8)] * 2 + ([(2, BS, 2)] * 2 if dtype == "int8"
                                  else [])
    assert [a.shape for a in sent] == want
    j.import_block(2, sent)
    back = j.export_block(2)
    t.import_block(5, back)
    for a, b, c in zip(sent, back, t.export_block(5)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for p in t.pools:
        assert torch.equal(p[:, 5], p[:, 3])
    bad = {"arity": sent[:1],
           "geometry": [a.astype(np.float64) for a in sent],
           "shape": [np.concatenate([a, a], axis=1) for a in sent]}
    for what, arrays in bad.items():
        for cache in (t, j):
            with pytest.raises(ValueError,
                               match="arity" if what == "arity"
                               else "geometry"):
                cache.import_block(1, arrays)


# -- a pair of the port -------------------------------------------------------

def test_pair_parity_phases_and_blocks(telemetry_on):
    """A prefill and a decode replica serve the reference's tokens with
    both halves' phases in the reply; the decode half prefix-matches the
    adopted prefix; a repeated prompt ships nothing; streaming works
    across the pair; no block stays in use."""
    with _pair() as (sp, sd, cli):
        long, short = (1, 2, 3, 4, 5, 6, 7, 8, 9), (2, 3)
        for p in ((3, 1, 4, 1, 5, 9, 2, 6, 5), long, (7, 7), short,
                  (9, 8, 7, 6, 5, 4, 3)):
            r = cli.generate("toy", list(p), max_new_tokens=6,
                             deadline_ms=LONG, stream=False)
            assert r.status == "ok", (r.status, r.error)
            np.testing.assert_array_equal(r.outputs["tokens"],
                                          _unpaged(p, 6))
            assert r.phases.get("role") == "disagg"
            for k in ("prefill_queue_wait_ms", "prefill_ms", "xfer_ms",
                      "queue_wait_ms"):
                assert k in r.phases, k
            assert r.phases["cached_tokens"] == ((len(p) - 1) // BS) * BS
        # (len - 1) // 4 blocks a prompt: 2 + 2 + 0 + 0 + 1
        assert _ctr("kv_xfer_blocks_total", dtype="f32") == 5
        assert _ctr("kv_xfer_adopt_total", result="adopted") == 5
        assert _ctr("kv_xfer_frames_total", kind="commit") == 5
        assert _ctr("serving_handoff_total") == 3
        before = _ctr("kv_xfer_blocks_total", dtype="f32")
        r = cli.generate("toy", list(long), max_new_tokens=6,
                         deadline_ms=LONG, stream=False)
        assert r.status == "ok"
        np.testing.assert_array_equal(r.outputs["tokens"], _unpaged(long, 6))
        assert _ctr("kv_xfer_blocks_total", dtype="f32") == before
        assert _ctr("kv_xfer_skipped_total") >= 2
        gauges = ttm.snapshot()["gauges"]
        for name in ("kv_pool_occupancy", "prefix_cache_hit_rate"):
            assert any(k.startswith(name) and "toy" in k for k in gauges)
        seen = []
        r = cli.generate("toy", [5, 6, 7, 8, 9], max_new_tokens=5,
                         deadline_ms=LONG, on_token=lambda i, t: seen.append(
                             (i, t)))
        assert r.status == "ok"
        assert seen == list(enumerate(_unpaged((5, 6, 7, 8, 9), 5)))
        for srv in (sp, sd):
            assert _in_use(srv.decode_engine) == 0


def test_adopted_blocks_are_bitwise_the_monoliths():
    """One prompt alone, every engine at the one lane bucket 4: the decode
    half's adopted blocks (and the prefill half's own) are bitwise the
    blocks a monolith engine computes under the same digests."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]       # 3 blocks move
    mono = _engine(buckets="4").start()
    try:
        r = mono.generate("toy", prompt, max_new_tokens=4, deadline_ms=LONG)
        assert r.status == "ok", r.error
    finally:
        mono.stop()
    with _pair(buckets="4") as (sp, sd, cli):
        got = cli.generate("toy", prompt, max_new_tokens=4,
                           deadline_ms=LONG, stream=False)
        assert got.status == "ok", got.error
        np.testing.assert_array_equal(got.outputs["tokens"],
                                      r.outputs["tokens"])
        assert got.phases["cached_tokens"] == 12
        mm = mono._models["toy"]
        for d in mm.prefix.chain(prompt):
            want = mm.cache.export_block(mm.prefix.lookup(d))
            for srv in (sd, sp):
                m = srv.decode_engine._models["toy"]
                for a, b in zip(m.cache.export_block(m.prefix.lookup(d)),
                                want):
                    np.testing.assert_array_equal(a, b)


def test_handoff_falls_back_to_the_monolith_without_a_peer(telemetry_on):
    """A prefill replica whose decode peer does not answer publishes
    {"decode": None} and serves the request itself: no failover."""
    e = _engine()
    sp = ServingServer(ServingEngine(device="cpu"), port=0, decode_engine=e,
                       role="prefill", decode_peers=["127.0.0.1:1"]).start()
    try:
        cli = ServingClient(endpoints=[_ep(sp)], roles=["prefill"])
        p = (1, 2, 3, 4, 5, 6)
        r = cli.generate("toy", list(p), max_new_tokens=5, deadline_ms=LONG)
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"], _unpaged(p, 5))
        assert cli.failovers == 0
        assert _ctr("serving_handoff_fallback_total") == 1
        assert _in_use(e) == 0
    finally:
        sp.shutdown()


_DECODE_CHILD = """
import sys, time
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      ServingEngine, ServingServer,
                                      init_decoder_params)
cfg = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
e = DecodeEngine(buckets="2,4", block_size=4, deadline_ms=30000.0,
                 device="cpu")
e.add_model("toy", (cfg, init_decoder_params(cfg, seed=7)), kv_blocks=64)
s = ServingServer(ServingEngine(device="cpu"), port=0, decode_engine=e,
                  role="decode").start()
print("PORT %d" % s.port, flush=True)
time.sleep(600)
"""


def test_decode_death_mid_stream_aborts_both_and_replays():
    """The decode half is SIGKILLed mid-stream: the client aborts both
    halves and goes on at the prefill replica (now peerless, serving
    itself), with the reference's tokens, each index once, and nothing
    left in use there."""
    child = subprocess.Popen([sys.executable, "-c", _DECODE_CHILD, ROOT],
                             stdout=subprocess.PIPE, text=True,
                             start_new_session=True)
    sp = None
    try:
        line = child.stdout.readline()
        assert line.startswith("PORT "), line
        dep = "127.0.0.1:%d" % int(line.split()[1])
        e = _engine()
        sp = ServingServer(ServingEngine(device="cpu"), port=0,
                           decode_engine=e, role="prefill",
                           decode_peers=[dep]).start()
        cli = ServingClient(endpoints=[_ep(sp), dep],
                            roles=["prefill", "decode"])
        p = (1, 2, 3, 4, 5, 6, 7, 8, 9)
        got = []
        first = threading.Event()

        def killer():
            first.wait(60.0)
            child.send_signal(signal.SIGKILL)

        kth = threading.Thread(target=killer, daemon=True)
        kth.start()

        def on_token(i, t):
            got.append((i, t))
            first.set()

        r = cli.generate("toy", list(p), max_new_tokens=24, deadline_ms=LONG,
                         on_token=on_token)
        kth.join(60.0)
        assert first.is_set(), "the decode half never streamed a token"
        assert child.wait(30) == -signal.SIGKILL
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"], _unpaged(p, 24))
        assert got == list(enumerate(_unpaged(p, 24).tolist()))
        assert cli.failovers >= 1
        assert _wait_until(lambda: _in_use(e) == 0)
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()
        child.wait(30)
        if sp is not None:
            sp.shutdown()


def test_the_orphan_janitor_frees_adopted_blocks(telemetry_on):
    """Blocks adopted for a request whose prefill half never answers are
    freed by the janitor, and the parked client gets "timeout" (its
    replay path)."""
    ed = _engine()
    sd = ServingServer(ServingEngine(device="cpu"), port=0, decode_engine=ed,
                       role="decode").start()
    try:
        m = ed._models["toy"]
        alloc = m.cache.allocator
        base_free = alloc.num_free
        rid, digest = "orphanreq", "ab" * 32
        c = RpcClient(_ep(sd), connect_timeout=2.0, rpc_deadline=30.0,
                      retry_times=0)
        try:
            c.send_var(codec.KVXFER_KEY + rid, codec.pack_kvxfer(
                {"kind": "expect", "req_id": rid, "model": "toy",
                 "prefill_ep": "127.0.0.1:1"}, ()))
            c.send_var(codec.KVXFER_KEY + rid, codec.pack_kvxfer(
                {"kind": "block", "req_id": rid, "pos": 0,
                 "digest": digest, "model": "toy", "dtype": "f32"},
                m.cache.export_block(1)))
            assert _wait_until(lambda: m.prefix.lookup(digest) is not None)
            meta, _ = codec.unpack(c.get_var(codec.REPLY_KEY + rid))
            assert meta["status"] == "timeout"
            assert "prefill half died" in meta["error"]
        finally:
            c.close()
        assert _wait_until(lambda: m.prefix.lookup(digest) is None)
        assert alloc.in_use == 0 and alloc.num_free == base_free
        assert _ctr("kv_xfer_orphans_total", reason="dead_peer") == 1
        assert _ctr("kv_xfer_forget_total") == 1
    finally:
        sd.shutdown()


def test_a_position_regression_is_refused(telemetry_on):
    """A block frame at or below a position already adopted is refused
    and never touches the pool."""
    ed = _engine()
    sd = ServingServer(ServingEngine(device="cpu"), port=0, decode_engine=ed,
                       role="decode").start()
    try:
        m = ed._models["toy"]
        payload = m.cache.export_block(1)
        rid, d1, d2 = "posreg", "11" * 32, "22" * 32
        c = RpcClient(_ep(sd), connect_timeout=2.0, rpc_deadline=10.0,
                      retry_times=0)
        try:
            for pos, d in ((1, d1), (0, d2)):
                c.send_var(codec.KVXFER_KEY + rid, codec.pack_kvxfer(
                    {"kind": "block", "req_id": rid, "pos": pos,
                     "digest": d, "model": "toy", "dtype": "f32"}, payload))
            assert _wait_until(lambda: _ctr("kv_xfer_rejected_total",
                                            reason="position") == 1)
            assert m.prefix.lookup(d1) is not None
            assert m.prefix.lookup(d2) is None
        finally:
            c.close()
    finally:
        sd.shutdown()


def test_int8_pair_parity_and_the_wire_bytes_budget(telemetry_on):
    """The wire dtype is the pools': an int8 pair's tokens are the port's
    int8 monolith's, and its frames take at most 0.55x the f32 pair's
    bytes for the same traffic (blocks of 8, where the payload outweighs
    the frame's header)."""
    p = tuple(range(1, 18))
    mono = _engine("int8", bs=8).start()
    try:
        want8 = mono.generate("toy", list(p), max_new_tokens=6,
                              deadline_ms=LONG).outputs["tokens"]
    finally:
        mono.stop()
    for dtype, want in (("f32", _unpaged(p, 6)), ("int8", want8)):
        with _pair(dtype, bs=8) as (sp, sd, cli):
            r = cli.generate("toy", list(p), max_new_tokens=6,
                             deadline_ms=LONG)
            assert r.status == "ok", (r.status, r.error)
            np.testing.assert_array_equal(r.outputs["tokens"], want)
            assert r.phases["cached_tokens"] == 16
    f32_bytes = _ctr("kv_xfer_bytes_total", dtype="f32")
    int8_bytes = _ctr("kv_xfer_bytes_total", dtype="int8")
    assert f32_bytes > 0 and int8_bytes > 0
    assert int8_bytes <= 0.55 * f32_bytes, (int8_bytes, f32_bytes)


# -- across packages ----------------------------------------------------------

def test_a_reference_prefill_feeds_a_port_decode(telemetry_on):
    """The reference's prefill replica (JAX engine) streams its sealed
    blocks to the port's decode replica: the reference's tokens, the
    prefix adopted, and the adopted blocks within 1e-6 of the port
    monolith's."""
    p = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    ed = _engine(buckets="2")
    sd = ServingServer(ServingEngine(device="cpu"), port=0, decode_engine=ed,
                       role="decode").start()
    sp = None
    try:
        sp = JServer(JServingEngine(), port=0,
                     decode_engine=_reference_engine(), role="prefill",
                     decode_peers=[_ep(sd)]).start()
        cli = ServingClient(endpoints=[_ep(sp), _ep(sd)],
                            roles=["prefill", "decode"])
        r = cli.generate("toy", p, max_new_tokens=6, deadline_ms=LONG)
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"],
                                      _unpaged(tuple(p), 6))
        assert r.phases["role"] == "disagg"
        assert r.phases["cached_tokens"] == 8
        assert _ctr("kv_xfer_adopt_total", result="adopted") == 2
        assert _in_use(ed) == 0
        mono = _engine(buckets="2").start()
        try:
            assert mono.generate("toy", p, max_new_tokens=1,
                                 deadline_ms=LONG).status == "ok"
        finally:
            mono.stop()
        m, mm = ed._models["toy"], mono._models["toy"]
        for d in mm.prefix.chain(p)[:2]:
            for a, b in zip(m.cache.export_block(m.prefix.lookup(d)),
                            mm.cache.export_block(mm.prefix.lookup(d))):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL_POOL)
    finally:
        if sp is not None:
            sp.shutdown()
        sd.shutdown()


def test_a_port_prefill_feeds_a_reference_decode():
    """The port's prefill replica streams to the reference's decode
    replica (JAX engine), which adopts the blocks (its own counter) and
    serves the reference's tokens."""
    p = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    je = _reference_engine()
    old = fluid.get_flags(["FLAGS_telemetry"])
    fluid.set_flags({"FLAGS_telemetry": True})
    jtm.reset()
    sd = JServer(JServingEngine(), port=0, decode_engine=je,
                 role="decode").start()
    sp = None
    try:
        sp = ServingServer(ServingEngine(device="cpu"), port=0,
                           decode_engine=_engine(buckets="2"),
                           role="prefill", decode_peers=[_ep(sd)]).start()
        cli = ServingClient(endpoints=[_ep(sp), _ep(sd)],
                            roles=["prefill", "decode"])
        r = cli.generate("toy", p, max_new_tokens=6, deadline_ms=LONG)
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"],
                                      _unpaged(tuple(p), 6))
        assert r.phases["role"] == "disagg"
        assert r.phases["cached_tokens"] == 8
        adopted = sum(v for k, v in jtm.snapshot()["counters"].items()
                      if k.startswith("kv_xfer_adopt_total")
                      and "result=adopted" in k)
        assert adopted == 2
        mj = je._models["toy"]
        assert all(mj.prefix.lookup(d) is not None
                   for d in mj.prefix.chain(p)[:2])
        assert _in_use(sp.decode_engine) == 0
    finally:
        if sp is not None:
            sp.shutdown()
        sd.shutdown()
        jtm.reset()
        fluid.set_flags(old)


# -- two replicas -------------------------------------------------------------

def _ready(proc, timeout=90.0):
    out = []

    def read():
        for line in proc.stdout:
            out.append(line)
            if line.startswith("READY"):
                return

    th = threading.Thread(target=read, daemon=True)
    th.start()
    th.join(timeout)
    assert out and out[-1].startswith("READY"), "".join(out)[-3000:]


def test_a_replica_pair_serves_the_demo_decoder(tmp_path):
    """``tools/torch_serve.py --roles prefill,decode`` over one fleet: the
    endpoints file carries the role column, the client's generate goes
    through the pair with the reference's tokens (one block of 16 moves),
    the replicas' ``__metrics__`` count the handoff and the adoption,
    and both exit 0 on SIGTERM with their SERVED lines."""
    sys.path.insert(0, os.path.dirname(_SERVE))
    from torch_serve import save_demo_decoder

    dec_dir = save_demo_decoder(str(tmp_path / "dec"))
    cfg, params = jdm.load_decoder(dec_dir)
    prompt, max_new = list(range(1, 21)), 6
    want = np.asarray(jdm.unpaged_generate(
        cfg, params, prompt, max_new, pad_len=-(-cfg.max_seq // 16) * 16),
        np.int32)
    eps_file = str(tmp_path / "eps.json")
    eps = ["127.0.0.1:%d" % p for p in free_ports(2)]
    env = dict(os.environ, FLAGS_telemetry="1",
               FLAGS_serving_hb_interval="0.2",
               FLAGS_serving_hb_timeout="3.0")
    procs = [subprocess.Popen(
        [sys.executable, "-u", _SERVE, "--device", "cpu", "--model",
         "toy=" + dec_dir, "--decode-buckets", "4", "--rank", str(rank),
         "--fleet", ",".join(eps), "--roles", "prefill,decode",
         "--endpoints-file", eps_file], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for rank in (0, 1)]
    try:
        for p in procs:
            _ready(p)

        def listed():
            try:
                with open(eps_file) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                return False
            return doc["endpoints"] == eps and \
                doc.get("roles") == ["prefill", "decode"]

        assert _wait_until(listed, 20.0)
        cli = ServingClient(endpoints_file=eps_file, deadline_ms=LONG)
        chunks = []
        r = cli.generate("toy", prompt, max_new_tokens=max_new,
                         on_token=lambda i, t: chunks.append((i, t)))
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        assert chunks == list(enumerate(want.tolist()))
        assert r.phases["role"] == "disagg"
        assert r.phases["cached_tokens"] == 16

        def counted():
            pre = ttm.scrape(eps[0], timeout=5.0)["counters"]
            dec = ttm.scrape(eps[1], timeout=5.0)["counters"]
            return pre.get("serving_handoff_total{model=toy}") == 1 and \
                dec.get("kv_xfer_adopt_total{model=toy,result=adopted}") \
                == 1

        assert _wait_until(counted, 15.0)
    finally:
        outs = []
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                out, _ = p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        served = [ln for ln in out.splitlines() if ln.startswith("SERVED ")]
        assert served and json.loads(served[0][7:])["decode_steps"] > 0
