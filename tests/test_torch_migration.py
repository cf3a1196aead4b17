"""Live decode-session migration on the port (paddle_tpu_torch/serving/
migrate.py, the DecodeEngine's export / commit / abort and resume
admission, the server's ``__resume__`` and session frames, the client's
resume and ``migrated_to`` follow), held against the JAX package on the
CPU at the reference tests' toy widths (vocab 31, 2 layers, 2 heads x 8,
blocks of 4).

The reference's migration cases (tests/test_session_migration.py:146-555)
are posed on the port: every resumed or migrated session's tokens are
bitwise the reference's ``unpaged_generate`` (int8 ones bitwise the
port's uninterrupted int8 run), each index reaches the client once, and
a resume whose history matched re-feeds less than one block.  The
port's chain, ``extend_chain`` and ``tail_digest`` digests are the
reference's.  Across packages, a session the reference exports continues
on the port with the reference's tokens; the reference is never asked to
resume one (its resume path fails under this suite's 8-device CPU mesh).
Every wait is bounded, and every engine, server and child process is
stopped in ``finally``.
"""

import functools
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import migrate as jmig
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      ServingClient, ServingEngine,
                                      ServingServer, init_decoder_params,
                                      truncate_decoder)
from paddle_tpu_torch.serving import codec
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving.migrate import tail_digest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
PARAMS = init_decoder_params(CFG, seed=7)
DRAFT = truncate_decoder(CFG, PARAMS, layers=1)
JCFG = jdm.DecoderConfig(**CFG.to_dict())
BS = 4
LONG = 30000.0
PROMPT = [1, 2, 3, 4, 5, 6, 7, 8, 9]


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
    """One counter summed over the label sets that hold ``labels``."""
    out = 0.0
    for key, v in ttm.snapshot()["counters"].items():
        if key.split("{")[0] == name and all(
                "%s=%s" % kv in key for kv in labels.items()):
            out += v
    return out


def _mkeng(dtype="f32", draft=None, k=None, kv_blocks=64):
    e = DecodeEngine(buckets="2,4", block_size=BS, deadline_ms=LONG,
                     kv_dtype=dtype, device="cpu")
    e.add_model("toy", (CFG, PARAMS), kv_blocks=kv_blocks, draft=draft,
                speculative_k=k)
    return e.start()


def _in_use(e):
    m = e._models["toy"]
    n = m.cache.allocator.in_use
    if m.draft_cache is not None:
        n += m.draft_cache.allocator.in_use
    return n


def _export_live(eng, prompt, max_new, after=5, want_tail=None, tries=10):
    """Submit one generation and export it once ``after`` tokens have
    streamed; with ``want_tail``, retry (aborting the export, which
    re-queues and completes harmlessly) until the snapshot does or does
    not carry a tail block."""
    for _ in range(tries):
        seen = threading.Event()
        count = [0]

        def on_tok(rid, i, t, done, status):
            count[0] += 1
            if count[0] >= after:
                seen.set()

        pending = eng.submit("toy", prompt, max_new_tokens=max_new,
                             deadline_ms=LONG, on_token=on_tok)
        assert seen.wait(30.0), "no %d tokens streamed" % after
        try:
            manifest, payloads = eng.export_session(pending.req_id)
        except ValueError:
            pending.wait(30.0)         # finished under us: again
            continue
        has_tail = any(is_tail for _, _, _, is_tail in payloads)
        if want_tail is None or has_tail == want_tail:
            return pending, manifest, payloads
        assert eng.abort_migration(pending.req_id)
        pending.wait(30.0)
    raise AssertionError("no export with want_tail=%s in %d tries"
                         % (want_tail, tries))


def _adopt_and_resume(dst, manifest, payloads, corrupt_tail=False):
    """The destination's half of a hand-off on the engine (what the
    server's session frames do over the wire) -> (reply, tokens held)."""
    resume_tail = None
    for pos, digest, arrays, is_tail in payloads:
        if is_tail:
            resume_tail = {
                "digest": "00" * 32 if corrupt_tail else digest,
                "valid": manifest["pos"] - pos * manifest["block_size"],
                "arrays": arrays}
        else:
            res = dst.adopt_kv_block(manifest["model"], digest, arrays)
            assert res in ("adopted", "cached"), res
    out = [int(t) for t in np.asarray(manifest["_out_arr"]).reshape(-1)]
    prompt = [int(t) for t in np.asarray(manifest["_prompt_arr"]).ravel()]
    reply = dst.generate(manifest["model"], prompt,
                         max_new_tokens=manifest["max_new_tokens"],
                         deadline_ms=LONG, eos_id=manifest["eos_id"],
                         resume_from=out, resume_tail=resume_tail)
    return reply, len(out)


# -- digests ------------------------------------------------------------------

def test_chain_and_tail_digests_equal_the_references():
    """``chain``, ``extend_chain`` block by block and ``tail_digest`` give
    the reference's hex digests for the same tokens; a tail digest is
    never a chain digest, even over a full block's tokens."""
    toks = np.random.RandomState(0).randint(0, 31, 23).tolist()
    t = tkv.PrefixCache(tkv.BlockAllocator(8, reserve=1), BS,
                        namespace="toy")
    j = jkv.PrefixCache(jkv.BlockAllocator(8, reserve=1), BS,
                        namespace="toy")
    chain = t.chain(toks)
    assert chain == j.chain(toks) and len(chain) == len(toks) // BS
    prev_t = prev_j = None
    for i in range(len(chain)):
        blk = toks[i * BS:(i + 1) * BS]
        prev_t, prev_j = t.extend_chain(prev_t, blk), \
            j.extend_chain(prev_j, blk)
        assert prev_t == prev_j == chain[i]
    tails = [tail_digest(None, toks[:3]), tail_digest(chain[-1], toks[-3:]),
             tail_digest(None, toks[:BS])]
    assert tails == [jmig.tail_digest(None, toks[:3]),
                     jmig.tail_digest(chain[-1], toks[-3:]),
                     jmig.tail_digest(None, toks[:BS])]
    assert not set(tails) & set(chain)
    assert tail_digest(chain[0], toks[BS:2 * BS]) != chain[1]


# -- the export manifest ------------------------------------------------------

def test_export_manifest_fields_and_abort_requeues(telemetry_on):
    eng = _mkeng()
    try:
        want = _unpaged(tuple(PROMPT), 24)
        pending, manifest, payloads = _export_live(eng, PROMPT, 24)
        pos = manifest["pos"]
        out = np.asarray(manifest["_out_arr"]).reshape(-1)
        assert manifest["req_id"] == pending.req_id
        assert (manifest["model"], manifest["block_size"],
                manifest["dtype"], manifest["max_new_tokens"],
                manifest["eos_id"], manifest["spec_k"]) == \
            ("toy", BS, "f32", 24, -1, 0)
        assert manifest["deadline_ms"] > 0 and manifest["stream"]
        # the last emitted token is always re-fed
        assert pos == len(PROMPT) + len(out) - 1
        assert len(manifest["digests"]) == pos // BS
        np.testing.assert_array_equal(out, want[:len(out)])
        nfull = pos // BS
        full = [p for p in payloads if not p[3]]
        tails = [p for p in payloads if p[3]]
        assert [p[0] for p in full] == list(range(nfull))
        assert [p[1] for p in full] == manifest["digests"]
        assert len(tails) == (1 if pos > nfull * BS else 0)
        for _, _, arrays, _ in payloads:
            assert [a.shape for a in arrays] == [(2, BS, 2, 8)] * 2
            assert all(a.dtype == np.float32 for a in arrays)
        if tails:
            j, td, _, _ = tails[0]
            hist = (PROMPT + [int(t) for t in out])[nfull * BS:pos]
            assert j == nfull and td == tail_digest(
                manifest["digests"][-1] if nfull else None, hist)
        # an abort re-queues for a local replay: the reply is the
        # uninterrupted one, its kept tokens re-fed, not re-emitted
        assert eng.abort_migration(pending.req_id)
        reply = pending.wait(60.0)
        assert reply is not None and reply.status == "ok", reply
        np.testing.assert_array_equal(reply.outputs["tokens"], want)
        assert reply.phases.get("resumed_tokens") == len(out)
        assert _in_use(eng) == 0
    finally:
        eng.stop()


def test_migrate_during_prefill_refused():
    eng = _mkeng()
    try:
        # holding the engine's lock (re-entrant) keeps the loop from
        # admitting: the request is queued with no token emitted
        with eng._cond:
            pending = eng.submit("toy", PROMPT, max_new_tokens=6,
                                 deadline_ms=LONG)
            with pytest.raises(ValueError, match="in_prefill"):
                eng.export_session(pending.req_id)
        reply = pending.wait(60.0)
        assert reply is not None and reply.status == "ok", reply
        np.testing.assert_array_equal(reply.outputs["tokens"],
                                      _unpaged(tuple(PROMPT), 6))
        for rid in (pending.req_id, "never-submitted"):
            with pytest.raises(ValueError, match="unknown"):
                eng.export_session(rid)
    finally:
        eng.stop()


def test_double_migration_refused(telemetry_on):
    eng = _mkeng()
    try:
        pending, _, _ = _export_live(eng, PROMPT, 24)
        rid = pending.req_id
        with pytest.raises(ValueError, match="already_migrating"):
            eng.export_session(rid)
        assert eng.commit_migration(rid, "127.0.0.1:1")
        reply = pending.wait(30.0)
        assert reply is not None and reply.status == "migrated"
        assert reply.phases.get("migrated_to") == "127.0.0.1:1"
        with pytest.raises(ValueError, match="already_migrated"):
            eng.export_session(rid)
        for reason in ("already_migrating", "already_migrated"):
            assert _ctr("kv_migrate_refused_total", reason=reason) == 1
        # a resume of a req_id live here is refused at admission
        live, _, _ = _export_live(eng, PROMPT, 24)
        assert eng.abort_migration(live.req_id)
        dup = eng.generate("toy", PROMPT, max_new_tokens=24,
                           deadline_ms=LONG, req_id=live.req_id,
                           resume_from=[5, 6])
        assert dup.status == "error" and "double migration" in dup.error
        assert _ctr("kv_migrate_refused_total", reason="duplicate") == 1
        assert live.wait(60.0).status == "ok"
        assert _in_use(eng) == 0
    finally:
        eng.stop()


# -- adopt, then resume -------------------------------------------------------

def test_adopt_then_resume_bitwise(telemetry_on):
    """Manifest, blocks and tail shipped to a cold engine: the session
    goes on with the reference's tokens, emitting only what was not
    emitted, after re-feeding one position (the last token)."""
    src, dst = _mkeng(), _mkeng()
    try:
        want = _unpaged(tuple(PROMPT), 24)
        pending, manifest, payloads = _export_live(src, PROMPT, 24,
                                                   want_tail=True)
        reply, n_resumed = _adopt_and_resume(dst, manifest, payloads)
        assert reply.status == "ok", (reply.status, reply.error)
        np.testing.assert_array_equal(reply.outputs["tokens"], want)
        assert reply.phases["resumed_tokens"] == n_resumed
        assert reply.phases["cached_tokens"] == manifest["pos"]
        assert manifest["pos"] - reply.phases["cached_tokens"] < BS
        assert _ctr("kv_migrate_resume_total", result="accepted") == 1
        # the adopted blocks hold bitwise what the source exported
        m = dst._models["toy"]
        for _, digest, arrays, is_tail in payloads:
            b = None if is_tail else m.prefix.lookup(digest)
            if b is not None:
                for got, sent in zip(m.cache.export_block(b), arrays):
                    np.testing.assert_array_equal(got, sent)
        assert src.commit_migration(pending.req_id, "dst")
        assert pending.wait(30.0).status == "migrated"
        assert _in_use(src) == _in_use(dst) == 0
    finally:
        src.stop()
        dst.stop()


def test_int8_scales_ride_the_manifest(telemetry_on):
    """Int8 pools ship [k, v, k_scale, v_scale] a block, and the resumed
    run's tokens are the uninterrupted int8 run's."""
    src, dst = _mkeng(dtype="int8"), _mkeng(dtype="int8")
    try:
        ref = src.generate("toy", PROMPT, max_new_tokens=24,
                           deadline_ms=LONG)
        assert ref.status == "ok", ref.error
        pending, manifest, payloads = _export_live(src, PROMPT, 24,
                                                   want_tail=True)
        assert manifest["dtype"] == "int8"
        for _, _, arrays, _ in payloads:
            assert [a.dtype for a in arrays] == [np.dtype(np.int8)] * 2 + \
                [np.dtype(np.float32)] * 2
            assert [a.shape for a in arrays] == [(2, BS, 2, 8)] * 2 + \
                [(2, BS, 2)] * 2
        reply, _ = _adopt_and_resume(dst, manifest, payloads)
        assert reply.status == "ok", (reply.status, reply.error)
        np.testing.assert_array_equal(reply.outputs["tokens"],
                                      ref.outputs["tokens"])
        assert reply.phases["cached_tokens"] == manifest["pos"]
        assert src.commit_migration(pending.req_id, "dst")
        pending.wait(30.0)
        assert _in_use(src) == _in_use(dst) == 0
    finally:
        src.stop()
        dst.stop()


def test_spec_state_rides_the_manifest(telemetry_on):
    """A speculating session moves mid-flight: the manifest carries k, the
    destination's draft adopts nothing and catches up by its ingest, and
    the tokens are the reference's greedy ones."""
    src = _mkeng(draft=DRAFT, k=3)
    dst = _mkeng(draft=DRAFT, k=3)
    try:
        pending, manifest, payloads = _export_live(src, PROMPT, 24)
        assert manifest["spec_k"] == 3
        reply, _ = _adopt_and_resume(dst, manifest, payloads)
        assert reply.status == "ok", (reply.status, reply.error)
        np.testing.assert_array_equal(reply.outputs["tokens"],
                                      _unpaged(tuple(PROMPT), 24))
        assert src.commit_migration(pending.req_id, "dst")
        pending.wait(30.0)
        assert _in_use(src) == _in_use(dst) == 0
    finally:
        src.stop()
        dst.stop()


def test_tail_mismatch_dropped_and_replayed(telemetry_on):
    src, dst = _mkeng(), _mkeng()
    try:
        pending, manifest, payloads = _export_live(src, PROMPT, 24,
                                                   want_tail=True)
        reply, _ = _adopt_and_resume(dst, manifest, payloads,
                                     corrupt_tail=True)
        assert reply.status == "ok", (reply.status, reply.error)
        np.testing.assert_array_equal(reply.outputs["tokens"],
                                      _unpaged(tuple(PROMPT), 24))
        # the full blocks matched, the tail was refused and replayed
        assert reply.phases["cached_tokens"] == (manifest["pos"] // BS) * BS
        assert _ctr("kv_migrate_refused_total", reason="tail_mismatch") == 1
        assert src.commit_migration(pending.req_id, "dst")
        pending.wait(30.0)
    finally:
        src.stop()
        dst.stop()


def test_warm_resume_skips_reprefill_through_the_history_index(
        telemetry_on):
    """A crash resume on an engine that ran the same generation matches
    its published history and re-feeds less than one block."""
    eng = _mkeng()
    try:
        first = eng.generate("toy", PROMPT, max_new_tokens=12,
                             deadline_ms=LONG)
        assert first.status == "ok", first.error
        np.testing.assert_array_equal(first.outputs["tokens"],
                                      _unpaged(tuple(PROMPT), 12))
        toks = [int(t) for t in first.outputs["tokens"]]
        reply = eng.generate("toy", PROMPT, max_new_tokens=12,
                             deadline_ms=LONG, resume_from=toks[:6])
        assert reply.status == "ok", (reply.status, reply.error)
        np.testing.assert_array_equal(reply.outputs["tokens"],
                                      first.outputs["tokens"])
        pos = len(PROMPT) + 6 - 1
        assert reply.phases["resumed_tokens"] == 6
        assert reply.phases["cached_tokens"] == (pos // BS) * BS
        assert pos - reply.phases["cached_tokens"] < BS
        # bad resumes are refused at admission
        for bad in ([], toks, [99]):
            r = eng.generate("toy", PROMPT, max_new_tokens=12,
                             deadline_ms=LONG, resume_from=bad)
            assert r.status == "error", bad
        assert _ctr("kv_migrate_refused_total", reason="bad_resume") == 3
        assert _in_use(eng) == 0
    finally:
        eng.stop()


# -- over the wire ------------------------------------------------------------

def _wait_live_decode(eng, timeout=30.0):
    """Until some sequence is past its prefill with tokens emitted."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with eng._cond:
            if any(s.out and not s.in_prefill for s in eng._active):
                return True
        time.sleep(0.002)
    return False


def test_drain_migrate_empties_without_drops(telemetry_on):
    """``drain(migrate=...)``: a retiring replica pushes its live session
    over the ``__kvxfer__`` wire; the destination resumes it; the
    streaming client follows "migrated" and sees each index once, with
    the reference's tokens."""
    ea, eb = _mkeng(), _mkeng()
    sb = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=eb).start()
    sa = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=ea,
                       decode_peers=["127.0.0.1:%d" % sb.port]).start()
    try:
        assert sa.migrator is not None and sb._resume_buf is not None
        cli = ServingClient(endpoints=["127.0.0.1:%d" % sa.port])
        want = _unpaged(tuple(PROMPT), 32)
        got, res = [], {}

        def run():
            gen = cli.generate_stream("toy", PROMPT, max_new_tokens=32,
                                      deadline_ms=LONG)
            while True:
                try:
                    got.append(next(gen))
                except StopIteration as stop:
                    res["r"] = stop.value
                    return

        th = threading.Thread(target=run, daemon=True)
        th.start()
        assert _wait_live_decode(ea)
        assert ea.drain(timeout_s=60.0,
                        migrate=sa.migrator.drain_push(trigger="drain"))
        th.join(60.0)
        assert not th.is_alive(), "the client never finished"
        r = res["r"]
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        assert got == list(enumerate(want.tolist()))
        assert _ctr("kv_migrate_sessions_total", trigger="drain") == 1
        assert _ctr("kv_migrate_resume_total", result="accepted") == 1
        assert _ctr("kv_migrate_failed_total") == 0
        assert _ctr("client_migrate_follow_total") == 1
        pos = len(PROMPT) + r.phases["resumed_tokens"] - 1
        assert pos - r.phases["cached_tokens"] < BS
        with ea._cond:
            assert not (ea._active or ea._waiting or ea._migrating)
        assert _in_use(ea) == 0
    finally:
        sa.shutdown()
        sb.shutdown()


def test_a_source_shut_down_after_its_drain_is_followed(telemetry_on):
    """A replica retired with migration exits as soon as its drain ends
    (``tools/torch_serve.py``: ``on_retire`` stops the server), which
    may be before its client reads anything more there: the source here
    withholds the migrated reply and shuts down.  The stream's last chunk
    names the destination, so the client follows it there without that
    read, and does not fall back to a crash resume."""
    ea, eb = _mkeng(), _mkeng()
    sb = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=eb).start()
    sa = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=ea,
                       decode_peers=["127.0.0.1:%d" % sb.port]).start()
    chunks = []
    publish = sa._publish_keyed

    def recording(key, buf):
        if key.startswith(codec.STREAM_KEY):
            chunks.append(codec.unpack(buf)[0])
        elif key.startswith(codec.REPLY_KEY) and \
                codec.unpack(buf)[0].get("status") == "migrated":
            return
        publish(key, buf)

    sa._publish_keyed = recording
    try:
        cli = ServingClient(endpoints=["127.0.0.1:%d" % sa.port])
        want = _unpaged(tuple(PROMPT), 32)
        got, res = [], {}

        def run():
            res["r"] = cli.generate(
                "toy", PROMPT, max_new_tokens=32, deadline_ms=LONG,
                on_token=lambda j, t: got.append((j, t)))

        th = threading.Thread(target=run, daemon=True)
        th.start()
        assert _wait_live_decode(ea)
        assert ea.drain(timeout_s=60.0,
                        migrate=sa.migrator.drain_push(trigger="drain"))
        sa.shutdown()
        th.join(60.0)
        assert not th.is_alive(), "the client never finished"
        last = chunks[-1]
        assert last["done"] and last["status"] == "migrated"
        assert last["migrated_to"] == "127.0.0.1:%d" % sb.port
        r = res["r"]
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        assert got == list(enumerate(want.tolist()))
        assert _ctr("client_migrate_follow_total") == 1
        assert _ctr("client_resume_total") == 0
        assert r.phases["resumed_tokens"] >= 1
    finally:
        sa.shutdown()
        sb.shutdown()


def test_pressure_preemption_migrates_the_victim(telemetry_on):
    """``FLAGS_migrate_on_pressure``: two sequences outgrow a 13-block
    pool, the youngest is preempted, and the engine's ``on_preempt`` hands
    it to the server, which pushes it to its peer instead of replaying it
    locally; both streams see each index once, with the reference's
    tokens."""
    set_flags({"FLAGS_migrate_on_pressure": True})
    ea, eb = _mkeng(kv_blocks=14), _mkeng()
    sb = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=eb).start()
    sa = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=ea,
                       decode_peers=["127.0.0.1:%d" % sb.port]).start()
    try:
        fired = []
        push = ea.on_preempt
        ea.on_preempt = lambda victims: (fired.append(list(victims)),
                                         push(victims))
        prompts = ([1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2, 1])
        res = {}

        def run(k):
            cli = ServingClient(endpoints=["127.0.0.1:%d" % sa.port])
            got = []
            res[k] = (cli.generate("toy", prompts[k], max_new_tokens=24,
                                   deadline_ms=LONG,
                                   on_token=lambda i, t: got.append((i, t))),
                      got)

        ths = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60.0)
        assert not any(th.is_alive() for th in ths)
        for k, (r, got) in res.items():
            assert r.status == "ok", (r.status, r.error)
            want = _unpaged(tuple(prompts[k]), 24)
            np.testing.assert_array_equal(r.outputs["tokens"], want)
            assert got == list(enumerate(want.tolist()))
        assert len(fired) == 1 and [m for _, m in fired[0]] == ["toy"]
        assert _ctr("kv_block_evictions_total") == 1
        assert _ctr("kv_migrate_sessions_total", trigger="pressure") == 1
        assert _ctr("client_migrate_follow_total") == 1
        assert _in_use(ea) == _in_use(eb) == 0
    finally:
        set_flags({"FLAGS_migrate_on_pressure": False})
        sa.shutdown()
        sb.shutdown()


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
s = ServingServer(ServingEngine(device="cpu"), port=0,
                  decode_engine=e).start()
print("PORT %d" % s.port, flush=True)
time.sleep(600)
"""


def test_sigkill_between_chunks_resumes_with_index_dedupe(telemetry_on):
    """The replica serving a stream is SIGKILLed between chunks; the
    client sends ``__resume__`` with the tokens it holds to the survivor
    (the same req_id, no full replay), and every index reaches it once,
    in order, with the reference's tokens."""
    child = subprocess.Popen([sys.executable, "-c", _DECODE_CHILD, ROOT],
                             stdout=subprocess.PIPE, text=True,
                             start_new_session=True)
    sv = None
    try:
        line = child.stdout.readline()
        assert line.startswith("PORT "), line
        vport = int(line.split()[1])
        es = _mkeng()
        sv = ServingServer(ServingEngine(device="cpu"), port=0,
                           decode_engine=es).start()
        # the victim first: attempt 0 lands on the child
        cli = ServingClient(endpoints=["127.0.0.1:%d" % vport,
                                       "127.0.0.1:%d" % sv.port])
        want = _unpaged(tuple(PROMPT), 32)
        got = []
        got_first = threading.Event()

        def killer():
            got_first.wait(60.0)
            child.send_signal(signal.SIGKILL)

        kth = threading.Thread(target=killer, daemon=True)
        kth.start()

        def on_token(i, t):
            got.append((i, t))
            got_first.set()

        r = cli.generate("toy", PROMPT, max_new_tokens=32, deadline_ms=LONG,
                         stream=True, on_token=on_token)
        kth.join(60.0)
        assert got_first.is_set(), "the victim never streamed a token"
        assert child.wait(30) == -signal.SIGKILL
        assert r.status == "ok", (r.status, r.error)
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        assert cli.failovers >= 1
        assert r.phases.get("resumed_tokens", 0) >= 1
        assert _ctr("client_resume_total", result="resumed") == 1
        assert got == list(enumerate(want.tolist()))
        assert _in_use(es) == 0
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()
        child.wait(30)
        if sv is not None:
            sv.shutdown()


# -- across packages ----------------------------------------------------------

def test_a_reference_export_resumed_by_the_port(telemetry_on):
    """The reference exports a live session mid-decode (f32, blocks of
    4); the port adopts its blocks and tail and resumes it with the
    reference's tokens, re-feeding one position."""
    old = fluid.get_flags(["FLAGS_kv_block_size", "FLAGS_kv_cache_dtype"])
    fluid.set_flags({"FLAGS_kv_block_size": BS,
                     "FLAGS_kv_cache_dtype": "f32"})
    try:
        je = JDecodeEngine(buckets="2", deadline_ms=LONG)
        je.add_model("toy", (JCFG, PARAMS), kv_blocks=64)
    finally:
        fluid.set_flags(old)
    je.start()
    dst = _mkeng()
    try:
        want = _unpaged(tuple(PROMPT), 24)
        pending, manifest, payloads = _export_live(je, PROMPT, 24,
                                                   want_tail=True)
        assert manifest["digests"] == dst._models["toy"].prefix.chain(
            PROMPT + [int(t) for t in manifest["_out_arr"]]
        )[:manifest["pos"] // BS]
        reply, n = _adopt_and_resume(dst, manifest, payloads)
        assert reply.status == "ok", (reply.status, reply.error)
        np.testing.assert_array_equal(reply.outputs["tokens"], want)
        assert reply.phases["resumed_tokens"] == n
        assert reply.phases["cached_tokens"] == manifest["pos"]
        assert _ctr("kv_xfer_adopt_total", result="adopted") == \
            manifest["pos"] // BS
        je.commit_migration(pending.req_id, "port")
        assert pending.wait(30.0).status == "migrated"
        assert _in_use(dst) == 0
    finally:
        je.stop()
        dst.stop()
