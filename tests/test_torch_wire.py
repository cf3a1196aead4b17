"""Wire serving of the port (paddle_tpu_torch/native/rpc.py over
csrc/tensor_rpc.cc, serving/codec.py, server.py, client.py) on the CPU,
held against the JAX package's transport, codec, client and server.

* The codec packs the reference's bytes for the same meta and arrays, and
  each side unpacks the other's; the two transports exchange frames both
  ways (a GET parks until its var exists; ``rpc_deadline`` trips; a probe
  of a closed port is None).
* The reference's wire scenarios (tests/test_serving.py:205, :233;
  tests/test_decode_serving.py:287, :319) re-posed on the port's server
  and client, the decode engines at ``device="cpu"``: tokens EQUAL to the
  JAX package's ``unpaged_generate`` on the same numpy params, encoder
  outputs to 1e-5 of the JAX predictor on the same rows.
* Across packages: the reference's client served by the port's server
  gets the port's own client's replies, and the port's client served by
  the reference's server (JAX engines) gets the reference's tokens.
* Abort, retire, the rollout table and the refused resume over the wire.

Every wait is bounded (``join``/``wait`` timeouts, ``rpc_deadline``) and
every server shuts down in ``finally``, so a hang fails in seconds.
"""

import contextlib
import functools
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import AnalysisPredictor as JPredictor
from paddle_tpu.native import rpc as jrpc
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import ServingClient as JClient
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ServingServer as JServer
from paddle_tpu.serving import codec as jcodec
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu_torch import get_flags, native, set_flags
from paddle_tpu_torch.native import rpc as trpc
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      ServingClient, ServingEngine,
                                      ServingServer, codec,
                                      init_decoder_params)

CFG = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
PARAMS = init_decoder_params(CFG, seed=7)
BIG = DecoderConfig(vocab=31, layers=6, heads=4, head_dim=32, max_seq=512)
BS = 4                      # block size of every decode engine here
LONG = 30000.0              # a deadline no request here reaches


@functools.lru_cache(maxsize=None)
def _ref_tokens(prompt, max_new):
    """The JAX package's greedy tokens for ``prompt`` (a tuple)."""
    jcfg = jdm.DecoderConfig(**CFG.to_dict())
    return np.asarray(jdm.unpaged_generate(jcfg, PARAMS, list(prompt),
                                           max_new), np.int32)


def _ep(srv):
    return "127.0.0.1:%d" % srv.port


def _decode_engine(kv_blocks=64, buckets="2", source=(CFG, PARAMS), **kw):
    kw.setdefault("deadline_ms", LONG)
    e = DecodeEngine(buckets=buckets, block_size=BS, device="cpu", **kw)
    e.add_model("toy", source, kv_blocks=kv_blocks)
    return e


def _in_use(e):
    return e._models["toy"].cache.allocator.in_use


def _wait_until(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.01)
    return cond()


@contextlib.contextmanager
def _serving(*servers):
    """Start each server, yield them, and shut every one down."""
    try:
        yield [s.start() for s in servers]
    finally:
        for s in servers:
            s.shutdown()


@pytest.fixture(scope="module")
def fc_dir(tmp_path_factory):
    """The reference test's fc model, saved by the JAX package."""
    d = str(tmp_path_factory.mktemp("fc") / "model")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        h = fluid.layers.fc(x, 16, act="relu")
        out = fluid.layers.fc(h, 4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.save_inference_model(d, ["x"], [out], exe, main_program=main)
    return d


def _fc_engine(fc_dir, **kw):
    kw.setdefault("buckets", (1, 4))
    eng = ServingEngine(device="cpu", **kw)
    eng.add_model("fc", fc_dir)
    return eng


def _fc_want(fc_dir, x):
    cfg = JConfig(fc_dir)
    cfg.disable_gpu()
    (_name, out), = JPredictor(cfg)._run_feed({"x": x}).items()
    return np.asarray(out)


# -- codec -------------------------------------------------------------------

CODEC_CASES = {
    "f32": ({"model": "m", "feeds": ["a"]},
            [np.arange(12, dtype=np.float32).reshape(3, 4)]),
    "f64": ({"k": 1.5}, [np.linspace(-1, 1, 7)]),
    "int32": ({"k": [1, 2]}, [np.arange(-3, 3, dtype=np.int32)]),
    "int64": ({}, [np.asarray([[1], [2]], dtype=np.int64)]),
    "uint8": ({"x": None}, [np.arange(256, dtype=np.uint8)]),
    "int8": ({"x": True}, [np.arange(-128, 128, dtype=np.int8)[::3]]),
    "f16": ({"x": "f16"}, [np.asarray([0.5, -2.0, 65504.0], np.float16)]),
    "bool": ({"x": 0}, [np.asarray([[True, False], [False, True]])]),
    "mixed": ({"feeds": ["a", "b"]},
              [np.ones((2, 3), np.float32), np.zeros((0, 5), np.int64),
               np.asarray(7, np.int32)]),
    "empty": ({"status": "ok", "outputs": []}, []),
    "unicode": ({"error": "délai dépassé ✓", "名前": "模型"},
                [np.asarray([1.0], np.float32)]),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_bytes_equal_the_reference(case):
    meta, arrays = CODEC_CASES[case]
    mine, theirs = codec.pack(meta, arrays), jcodec.pack(meta, arrays)
    assert mine.dtype == np.uint8 and mine.tobytes() == theirs.tobytes()
    for unpack, buf in ((codec.unpack, theirs), (jcodec.unpack, mine)):
        got_meta, got = unpack(buf)
        assert got_meta == meta and len(got) == len(arrays)
        for a, b in zip(arrays, got):
            a = np.ascontiguousarray(a)       # what pack sends: 0-d -> [1]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_codec_keys_are_the_reference_keys():
    for name in jcodec.__all__:
        if name.isupper() or name in ("TRACEPARENT", "TIER"):
            assert getattr(codec, name) == getattr(jcodec, name), name
    assert set(codec.__all__) == set(jcodec.__all__)


def test_kvxfer_frames_agree_and_a_truncated_frame_raises():
    meta = {"kind": "block", "req_id": "r1", "pos": 3, "digest": "ab" * 32,
            "model": "toy"}
    arrays = [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              np.ones((2, 3), np.float32)]
    mine = codec.pack_kvxfer(meta, arrays)
    assert mine.tobytes() == jcodec.pack_kvxfer(meta, arrays).tobytes()
    for unpack in (codec.unpack_kvxfer, jcodec.unpack_kvxfer):
        got_meta, got = unpack(mine, expect_pos=3)
        assert got_meta["digest"] == meta["digest"] and len(got) == 2
        np.testing.assert_array_equal(got[0], arrays[0])
        for bad in (mine[:-5], mine[:6]):
            with pytest.raises(ValueError):
                unpack(bad)
        with pytest.raises(ValueError):
            unpack(mine, expect_pos=4)
    with pytest.raises(ValueError):
        codec.pack_kvxfer({"kind": "nope", "req_id": "r"})


# -- transport ---------------------------------------------------------------

WIRE_ARRAYS = [np.arange(6, dtype=np.float32).reshape(2, 3),
               np.asarray([1.5, -2.25]), np.arange(5, dtype=np.int32),
               np.asarray([[7]], np.int64), np.arange(3, dtype=np.uint8),
               np.asarray([-1, 2], np.int8), np.asarray([0.5], np.float16),
               np.asarray([True, False]), np.zeros((0, 4), np.float32)]


def _poll_sends(server, n, timeout=10.0):
    """The next ``n`` SEND events of ``server`` (polled on a thread, so a
    missing frame fails instead of blocking)."""
    got = []

    def run():
        while len(got) < n:
            t, name, arr = server.poll()
            if t == 0:
                return
            if t == trpc.EV_SEND:
                got.append((name, arr))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "frames missing: %d of %d" % (len(got), n)
    return got


def test_reference_client_to_port_server_frames():
    """The reference's RpcClient sends each wire dtype to the port's
    RpcServer; the poll gives the same name, dtype, shape and bytes, and
    drops a reference trace context from the name."""
    srv = trpc.RpcServer(0)
    try:
        c = jrpc.RpcClient("127.0.0.1:%d" % srv.port, connect_timeout=5.0,
                           rpc_deadline=5.0, retry_times=0)
        try:
            for i, a in enumerate(WIRE_ARRAYS):
                c.send_var("var_%d" % i, a)
            tp = "00-%s-%s-01" % ("ab" * 16, "cd" * 8)
            c.send_var("__infer__:r1\x1f" + tp, WIRE_ARRAYS[0])
        finally:
            c.close()
        got = _poll_sends(srv, len(WIRE_ARRAYS) + 1)
    finally:
        srv.shutdown()
    for i, a in enumerate(WIRE_ARRAYS):
        name, arr = got[i]
        assert name == "var_%d" % i
        assert arr.dtype == a.dtype and arr.shape == a.shape
        assert arr.tobytes() == a.tobytes()
    assert got[-1][0] == "__infer__:r1"


def test_port_client_reads_reference_server():
    srv = jrpc.RpcServer(0)
    try:
        for i, a in enumerate(WIRE_ARRAYS):
            srv.set_var("var_%d" % i, a)
        srv.serve(True)
        c = trpc.RpcClient("127.0.0.1:%d" % srv.port, connect_timeout=5.0,
                           rpc_deadline=5.0, retry_times=0)
        try:
            for i, a in enumerate(WIRE_ARRAYS):
                got = c.get_var("var_%d" % i)
                assert got.dtype == a.dtype and got.shape == a.shape
                assert got.tobytes() == a.tobytes()
            c.send_var("up", np.ones(2, np.float32))  # acked both ways
        finally:
            c.close()
    finally:
        srv.shutdown()


def test_the_server_counts_the_bytes_that_crossed():
    """RpcServer.bytes_moved: a SEND's frame in and its bare ack out (a
    frame's header is 15 bytes, then the name, 8 a dim, the payload), a
    GET's frame in and its reply out."""
    srv = trpc.RpcServer(0)
    try:
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        srv.set_var("held", a)
        srv.serve(True)
        c = trpc.RpcClient("127.0.0.1:%d" % srv.port, connect_timeout=5.0,
                           rpc_deadline=5.0, retry_times=0)
        try:
            c.send_var("up", a)
            c.get_var("held")
        finally:
            c.close()
        want = (15 + 2 + 16 + 24 + 15 + 4, 15 + 15 + 4 + 16 + 24)
        deadline = time.time() + 5.0
        while srv.bytes_moved() != want and time.time() < deadline:
            time.sleep(0.01)
        assert srv.bytes_moved() == want
    finally:
        srv.shutdown()


def test_get_parks_until_set_var_and_the_deadline_trips():
    srv = trpc.RpcServer(0)
    ep = "127.0.0.1:%d" % srv.port
    try:
        srv.serve(True)
        out = {}

        def get():
            c = trpc.RpcClient(ep, connect_timeout=5.0, rpc_deadline=10.0,
                               retry_times=0)
            try:
                out["v"] = c.get_var("late")
            finally:
                c.close()

        th = threading.Thread(target=get, daemon=True)
        th.start()
        time.sleep(0.3)
        assert "v" not in out and th.is_alive()   # parked
        srv.set_var("late", np.asarray([4, 5], np.int64))
        th.join(10.0)
        assert not th.is_alive()
        np.testing.assert_array_equal(out["v"], [4, 5])

        c = trpc.RpcClient(ep, connect_timeout=5.0, rpc_deadline=0.3,
                           retry_times=0)
        t0 = time.perf_counter()
        with pytest.raises(ConnectionError, match="deadline"):
            c.get_var("never")
        assert 0.25 <= time.perf_counter() - t0 < 5.0
        with pytest.raises(ConnectionError, match="closed"):
            c.get_var("late")             # a failed client stays closed
    finally:
        srv.shutdown()


def test_probe_and_backoff():
    srv = trpc.RpcServer(0)
    try:
        srv.set_var("__alive__", np.asarray([2, 0, 1], np.int64))
        srv.serve(True)
        np.testing.assert_array_equal(
            trpc.probe("127.0.0.1:%d" % srv.port), [2, 0, 1])
        assert trpc.probe("127.0.0.1:%d" % srv.port, key="missing",
                          timeout=0.3) is None
    finally:
        srv.shutdown()
    assert trpc.probe("127.0.0.1:1") is None   # nothing listens there
    rng = np.random.RandomState(0)
    for attempt in range(6):
        d = min(2.0, 0.05 * 2 ** attempt)
        assert d / 2 <= trpc.backoff_delay(attempt, rng=rng) <= d


def test_the_library_is_built_from_the_port_source(tmp_path, monkeypatch):
    """The transport loads from build/native/, keyed by the source; a
    source g++ cannot build raises."""
    lib = native.load()
    path = native.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build" and path.exists()
    assert lib._name == str(path)
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build(native.library_path())


# -- the reference's wire scenarios, re-posed ---------------------------------

def test_wire_roundtrip_spec_infer_alive(fc_dir):
    """tests/test_serving.py:205 without the scrape: the spec, one infer
    (the JAX predictor's values), alive, and a probe of nothing."""
    eng = _fc_engine(fc_dir)
    eng.prewarm()
    with _serving(ServingServer(eng, port=0, rank=3)) as (srv,):
        cli = ServingClient(endpoints=[_ep(srv)])
        spec = cli.spec("fc")
        assert spec["buckets"] == [1, 4]
        assert spec["feeds"]["x"]["shape"] == [8]
        x = np.random.RandomState(1).rand(2, 8).astype("f")
        r = cli.infer("fc", {"x": x})
        assert r.ok, r.error
        out, = r.outputs.values()
        assert out.shape == (2, 4) and r.latency_ms > 0
        np.testing.assert_allclose(out, _fc_want(fc_dir, x), atol=1e-5)
        assert cli.alive(_ep(srv)) == [3, 0, 0]
        assert cli.alive("127.0.0.1:1") is None


def test_wire_bad_request_and_concurrent_clients(fc_dir):
    """tests/test_serving.py:233: six client threads of 1-3 rows, then a
    wrong feed name that comes back status=error."""
    eng = _fc_engine(fc_dir, batch_window_ms=5.0)
    eng.prewarm()
    with _serving(ServingServer(eng, port=0)) as (srv,):
        rng = np.random.RandomState(2)
        xs = [rng.rand(1 + i % 3, 8).astype("f") for i in range(6)]
        results = {}

        def one(i):
            results[i] = ServingClient(endpoints=[_ep(srv)]).infer(
                "fc", {"x": xs[i]})

        ts = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
        assert len(results) == 6
        for i, r in results.items():
            assert r.ok, r.error
            out, = r.outputs.values()
            np.testing.assert_allclose(out, _fc_want(fc_dir, xs[i]),
                                       atol=1e-5)
        r = ServingClient(endpoints=[_ep(srv)]).infer(
            "fc", {"y": np.ones((1, 8), "f")})
        assert r.status == "error" and "missing feed" in r.error


def test_generate_over_the_wire_stream_and_not():
    """tests/test_decode_serving.py:287, with the JAX package's tokens."""
    e = _decode_engine()
    with _serving(ServingServer(ServingEngine(device="cpu"), port=0,
                                decode_engine=e)) as (srv,):
        cli = ServingClient(endpoints=[_ep(srv)])
        spec = cli.spec("toy")
        assert spec["type"] == "decode" and spec["block_size"] == BS
        assert spec["kv_dtype"] == "f32" and spec["speculative_k"] == 0
        want = _ref_tokens((2, 3), 5)
        r = cli.generate("toy", [2, 3], max_new_tokens=5, deadline_ms=LONG,
                         stream=False)
        assert r.status == "ok"
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        seen = []
        r = cli.generate("toy", [2, 3], max_new_tokens=5, deadline_ms=LONG,
                         stream=True, on_token=lambda i, t: seen.append(t))
        assert r.status == "ok" and seen == list(want)
        assert r.phases["client_ttft_ms"] > 0
        assert len(r.phases["client_itl_ms_samples"]) == 4
        chunks = list(cli.generate_stream("toy", [2, 3], max_new_tokens=5,
                                          deadline_ms=LONG))
        assert chunks == list(enumerate(want))
        # a bad model's terminal error chunk does not hang the stream
        assert cli.generate("zzz", [1], deadline_ms=4000.0).status == "error"


def test_speculative_engine_over_the_wire_to_both_clients():
    """A port server over a speculative (k = 3, one-layer draft) and an
    int8 decode engine: ``__spec__`` carries the new keys, and both
    packages' clients get the reference's plain greedy tokens, a
    multi-token accept streaming chunks 0..n-1 once each."""
    from paddle_tpu_torch.serving import truncate_decoder

    spec_e = DecodeEngine(buckets="2", block_size=BS, device="cpu",
                          deadline_ms=LONG)
    spec_e.add_model("toy", (CFG, PARAMS), kv_blocks=64,
                     draft=truncate_decoder(CFG, PARAMS, layers=1),
                     speculative_k=3)
    int8_e = DecodeEngine(buckets="2", block_size=BS, device="cpu",
                          deadline_ms=LONG, kv_dtype="int8")
    int8_e.add_model("toy", (CFG, PARAMS), kv_blocks=64)
    for e in (spec_e, int8_e):
        e.start()
    try:
        with _serving(ServingServer(ServingEngine(device="cpu"), port=0,
                                    decode_engine=spec_e),
                      ServingServer(ServingEngine(device="cpu"), port=0,
                                    decode_engine=int8_e)) as (srv, srv8):
            for cli in (ServingClient(endpoints=[_ep(srv)]),
                        JClient(endpoints=[_ep(srv)])):
                spec = cli.spec("toy")
                assert spec["speculative_k"] == 3 and spec["kv_dtype"] == \
                    "f32"
                assert spec["draft"] == {
                    "layers": 1, "num_blocks": 64,
                    "kv_bytes": spec_e._models["toy"].draft_cache.nbytes}
                want = _ref_tokens((2, 3), 9)
                r = cli.generate("toy", [2, 3], max_new_tokens=9,
                                 deadline_ms=LONG, stream=False)
                assert r.status == "ok"
                np.testing.assert_array_equal(r.outputs["tokens"], want)
                seen = []
                r = cli.generate("toy", [2, 3], max_new_tokens=9,
                                 deadline_ms=LONG, stream=True,
                                 on_token=lambda i, t: seen.append((i, t)))
                assert r.status == "ok"
                assert seen == list(enumerate(want.tolist()))
            spec8 = ServingClient(endpoints=[_ep(srv8)]).spec("toy")
            assert spec8["kv_dtype"] == "int8" and \
                spec8["speculative_k"] == 0 and "draft" not in spec8
        assert spec_e._models["toy"].rollouts > 0
    finally:
        for e in (spec_e, int8_e):
            e.stop()


def test_client_replays_on_server_timeout():
    """tests/test_decode_serving.py:319: replica A (request mode) is busy
    with a long generation admitted before the client sends, so the
    client's request expires in A's queue; the timeout reply replays it
    on replica B, which answers with the JAX package's tokens."""
    big = (BIG, init_decoder_params(BIG, seed=3))
    ea = _decode_engine(kv_blocks=140, buckets="1", mode="request",
                        source=big)
    eb = _decode_engine(buckets="1")
    with _serving(ServingServer(ServingEngine(device="cpu"), port=0,
                                decode_engine=ea),
                  ServingServer(ServingEngine(device="cpu"), port=0,
                                decode_engine=eb)) as (sa, sb):
        busy = [ea.submit("toy", [1, 2], max_new_tokens=500,
                          deadline_ms=120000.0) for _ in range(2)]
        try:
            assert _wait_until(lambda: ea._active), "busy never admitted"
            cli = ServingClient(endpoints=[_ep(sa), _ep(sb)])
            r = cli.generate("toy", [9, 8, 7], max_new_tokens=4,
                             deadline_ms=300.0)
            assert r.status == "ok", (r.status, r.error)
            assert cli.failovers >= 1
            np.testing.assert_array_equal(r.outputs["tokens"],
                                          _ref_tokens((9, 8, 7), 4))
        finally:
            for b in busy:
                ea.abort(b.req_id)


# -- across packages ---------------------------------------------------------

def test_reference_client_against_the_port_server(fc_dir):
    """The JAX package's ServingClient, served by the port's server, gets
    the replies the port's own client gets: infer, generate with and
    without the stream, and generate_stream."""
    eng = _fc_engine(fc_dir)
    eng.prewarm()
    with _serving(ServingServer(eng, port=0,
                                decode_engine=_decode_engine())) as (srv,):
        mine = ServingClient(endpoints=[_ep(srv)])
        theirs = JClient(endpoints=[_ep(srv)])
        assert theirs.spec("toy") == mine.spec("toy")
        x = np.random.RandomState(4).rand(3, 8).astype("f")
        a, b = mine.infer("fc", {"x": x}), theirs.infer("fc", {"x": x})
        assert a.ok and b.ok, (a.error, b.error)
        np.testing.assert_array_equal(list(a.outputs.values())[0],
                                      list(b.outputs.values())[0])
        want = _ref_tokens((4, 5, 6), 6)
        for stream in (False, True):
            seen = []
            for cli in (mine, theirs):
                r = cli.generate("toy", [4, 5, 6], max_new_tokens=6,
                                 deadline_ms=LONG, stream=stream,
                                 on_token=lambda i, t: seen.append(t))
                assert r.status == "ok", r.error
                np.testing.assert_array_equal(r.outputs["tokens"], want)
            assert seen == (list(want) * 2 if stream else [])
        assert list(theirs.generate_stream(
            "toy", [4, 5, 6], max_new_tokens=6, deadline_ms=LONG)) == \
            list(enumerate(want))
        assert theirs.alive(_ep(srv)) == [0, 0, 0]


def test_port_client_against_the_reference_server():
    """The port's ServingClient, served by the JAX package's server over
    its DecodeEngine on the CPU, gets the reference's tokens."""
    old = fluid.get_flags(["FLAGS_kv_block_size", "FLAGS_kv_cache_dtype"])
    fluid.set_flags({"FLAGS_kv_block_size": BS,
                     "FLAGS_kv_cache_dtype": "f32"})
    try:
        je = JDecodeEngine(buckets="1", deadline_ms=LONG)
        je.add_model("toy", (jdm.DecoderConfig(**CFG.to_dict()), PARAMS),
                     kv_blocks=64)
    finally:
        fluid.set_flags(old)
    with _serving(JServer(JServingEngine(), port=0,
                          decode_engine=je)) as (srv,):
        cli = ServingClient(endpoints=[_ep(srv)])
        assert cli.spec("toy")["type"] == "decode"
        want = _ref_tokens((2, 3), 5)
        r = cli.generate("toy", [2, 3], max_new_tokens=5, deadline_ms=LONG,
                         stream=False)
        assert r.status == "ok", r.error
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        assert list(cli.generate_stream("toy", [2, 3], max_new_tokens=5,
                                        deadline_ms=LONG)) == \
            list(enumerate(want))


# -- abort, retire, control frames -------------------------------------------

def test_abort_over_the_wire_frees_the_blocks():
    """A streaming request abandoned mid-stream: the client's __abort__
    frees every KV block the sequence held, and the parked stream gets
    its terminal chunk."""
    # a long generation, so the abort lands before it could finish
    e = _decode_engine(kv_blocks=140, buckets="1", prefix_cache=False,
                       source=(BIG, init_decoder_params(BIG, seed=3)))
    big_prompt = list(range(1, 21))
    with _serving(ServingServer(ServingEngine(device="cpu"), port=0,
                                decode_engine=e)) as (srv,):
        before = _in_use(e)
        rid = "abandoned"
        c = trpc.RpcClient(_ep(srv), connect_timeout=5.0, rpc_deadline=10.0,
                           retry_times=0)
        try:
            c.send_var(codec.GEN_KEY + rid, codec.pack(
                {"model": "toy", "max_new_tokens": 400, "stream": True,
                 "deadline_ms": LONG}, [np.asarray(big_prompt, np.int32)]))
            first, _ = codec.unpack(c.get_var(codec.STREAM_KEY + rid + ":0"))
            assert first["token"] is not None and _in_use(e) > before
            ServingClient(endpoints=[_ep(srv)])._abort(_ep(srv), rid)
            assert _wait_until(lambda: _in_use(e) == before)
            meta, _ = codec.unpack(c.get_var(codec.REPLY_KEY + rid))
            assert meta["status"] == "aborted"
        finally:
            c.close()


def test_retire_drains_and_fires_on_retire(fc_dir):
    e = _decode_engine()
    srv = ServingServer(_fc_engine(fc_dir), port=0, decode_engine=e)
    retired = threading.Event()
    srv.on_retire = retired.set
    with _serving(srv):
        cli = ServingClient(endpoints=[_ep(srv)])
        pending = e.submit("toy", [3, 4], max_new_tokens=8)
        c = trpc.RpcClient(_ep(srv), connect_timeout=5.0, rpc_deadline=10.0,
                           retry_times=0)
        try:
            c.send_var(codec.RETIRE_KEY, codec.pack({}))
        finally:
            c.close()
        assert retired.wait(20.0)
        reply = pending.wait(10.0)
        assert reply is not None and reply.status == "ok"
        np.testing.assert_array_equal(reply.outputs["tokens"],
                                      _ref_tokens((3, 4), 8))
        r = cli.generate("toy", [1], deadline_ms=4000.0, max_attempts=1)
        assert r.status == "shed" and "draining" in r.error


def test_rollout_frames_and_the_refused_resume(fc_dir):
    """The rollout frames, and a ``__resume__`` refused (with migration
    off, on a server without a decode engine)."""
    eng = _fc_engine(fc_dir)
    eng.add_model("fc_v2", fc_dir)
    old = get_flags("FLAGS_session_migration")
    set_flags({"FLAGS_session_migration": False})
    with contextlib.ExitStack() as stack:
        stack.callback(set_flags, old)
        srv, = stack.enter_context(_serving(ServingServer(eng, port=0)))
        assert srv.migrator is None
        ep = _ep(srv)
        c = trpc.RpcClient(ep, connect_timeout=5.0, rpc_deadline=10.0,
                           retry_times=0)
        try:
            assert codec.unpack(c.get_var(codec.ROLLOUT_KEY))[0] == \
                {"models": {}}
            route = {"active": "fc", "canary": "fc_v2", "fraction": 0.5,
                     "state": "canary"}
            c.send_var(codec.ROLLOUT_SET_KEY, codec.pack(
                {"models": {"fc": route, "ghost": {"active": "nope"}}}))
            assert _wait_until(lambda: eng.routes() != {})
            assert codec.unpack(c.get_var(codec.ROLLOUT_KEY))[0] == \
                {"models": {"fc": route}}
            c.send_var(codec.ROLLOUT_CTL_KEY + "r1", codec.pack(
                {"cmd": "status"}))
            meta, _ = codec.unpack(c.get_var(codec.REPLY_KEY + "r1"))
            assert meta["status"] == "error" and "rollout controller" in \
                meta["error"]
            c.send_var(codec.RESUME_KEY + "r2", codec.pack(
                {"model": "toy"}, [np.asarray([1], np.int32),
                                   np.asarray([2], np.int32)]))
            meta, _ = codec.unpack(c.get_var(codec.RESUME_ACK_KEY + "r2"))
            assert meta["status"] == "refused"
            c.send_var(codec.INFER_KEY + "r3", np.arange(5, dtype=np.uint8))
            meta, _ = codec.unpack(c.get_var(codec.REPLY_KEY + "r3"))
            assert meta["status"] == "error" and "malformed" in meta["error"]
        finally:
            c.close()


def test_the_left_out_roles_raise(fc_dir):
    """The prefill and decode roles construct (serving/disagg.py); an
    unknown role raises as in the reference, and so do a client's roles
    that do not parallel its endpoints."""
    for role in ("serve", "prefill", "decode"):
        srv = ServingServer(_fc_engine(fc_dir), role=role)
        assert srv.role == role
        srv.rpc.shutdown()
    with pytest.raises(ValueError, match="serve\\|prefill\\|decode"):
        ServingServer(_fc_engine(fc_dir), role="router")
    cli = ServingClient(endpoints=["127.0.0.1:1", "127.0.0.1:2"],
                        roles=["prefill", "decode"])
    assert cli.endpoints_with_roles() == [("127.0.0.1:1", "prefill"),
                                          ("127.0.0.1:2", "decode")]
    with pytest.raises(ValueError, match="parallel"):
        ServingClient(endpoints=["127.0.0.1:1"], roles=["prefill", "decode"])
    with pytest.raises(ValueError, match="endpoints"):
        ServingClient()
