"""The port's tracing and flight recorder (``paddle_tpu_torch/core/
tracing.py``) against the reference's (``paddle_tpu/core/tracing.py``).

``tests/test_tracing.py``'s cases re-posed on the port: off is inert,
nesting is per thread, links, the traceparent round trip, wire stamping,
retroactive spans, the bounded ring, rotation and a flight dump on an
injected fault.  The same script of calls run through both packages must
leave records of the same layout, key for key.  In process on the CPU, a
wire request leaves the reference's span chain (``client.infer`` ->
``serving.admission`` -> ``serving.request`` -> ``serving.batch`` ->
``serving.execute`` -> ``executor.step``; a generate's
``serving.decode_step`` linking its request span), and the Executor
records its steps.  Across processes, a reference client against a port
replica and a port client against a reference replica each carry one
trace id through both processes' files, and the reference's
``tools/trace_view.py`` merges them with a flow arrow.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.core import tracing as jtr
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.core import tracing as tr
from paddle_tpu_torch.utils import fault_injection as tfi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
OFF = {"FLAGS_tracing": False, "FLAGS_telemetry": False,
       "FLAGS_telemetry_dir": "", "FLAGS_telemetry_max_bytes": 256 << 20,
       "FLAGS_fault_spec": ""}


@pytest.fixture(autouse=True)
def _clean_tracing():
    for m in (tr, jtr, ttm, jtm):
        m.reset()
    tfi.disarm()
    jfi.disarm()
    yield
    set_flags(OFF)
    fluid.set_flags(OFF)
    for m in (tr, jtr, ttm, jtm):
        m.reset()
    tfi.disarm()
    jfi.disarm()


def _tracing_on(tmp_path, name="tel"):
    d = str(tmp_path / name)
    set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": d})
    return d


def _read(d, pid=None):
    path = os.path.join(d, "trace-%d.jsonl" % (pid or os.getpid()))
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _spans(recs):
    return [r for r in recs if r["t"] == "span"]


# -- off is inert ----------------------------------------------------------------

def test_off_is_inert_no_files_no_counters(tmp_path):
    d = str(tmp_path / "tel")
    set_flags({"FLAGS_telemetry_dir": d})     # tracing stays off
    s = tr.start_span("x", a=1)
    assert s is tr._NULL_SPAN
    assert s.annotate(b=2) is s and s.link(None) is s and s.end() is s
    assert s.traceparent is None and s.context is None
    with tr.span("y") as y:
        assert y is tr._NULL_SPAN
        assert tr.current_span() is None and tr.traceparent() is None
    with tr.remote_parent("00-%s-%s-01" % ("a" * 32, "b" * 16)):
        assert tr.start_span("z") is tr._NULL_SPAN
    tr.instant("i")
    tr.note("n", k=1)
    tr.wire_received("k", "00-%s-%s-01" % ("a" * 32, "b" * 16))
    assert tr.record_span("r", time.time(), 1.0) is tr._NULL_SPAN
    assert tr.flight_dump() is None
    assert tr.stamp_wire_name("__infer__:r") == "__infer__:r"
    assert not os.path.exists(d)
    assert tr._flight == [] and ttm.snapshot()["counters"] == {}


def test_off_serving_and_executor_leave_no_file(tmp_path):
    """The whole traced path with tracing off (telemetry on, a telemetry
    dir set): requests served, no trace or flight file, no tracing
    counter."""
    d = str(tmp_path / "tel")
    set_flags({"FLAGS_telemetry": True, "FLAGS_telemetry_dir": d})
    cli, srv = _serve_in_process(tmp_path)
    try:
        assert cli.infer("fc", {"x": np.ones((2, 8), np.float32)}).ok
        assert cli.generate("toy", [1, 2, 3], max_new_tokens=3).ok
    finally:
        srv.shutdown()
    names = os.listdir(d) if os.path.exists(d) else []
    assert not [n for n in names if n.startswith(("trace-", "flightrec-"))]
    assert not [k for k in ttm.snapshot()["counters"]
                if k.startswith("tracing_")]


# -- span semantics ---------------------------------------------------------------

def test_span_nesting_and_records(tmp_path):
    d = _tracing_on(tmp_path)
    with tr.span("outer", job="j") as outer:
        assert tr.current_span() is outer
        with tr.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
        tr.instant("mark", step=3)
    recs = _read(d)
    assert recs[0]["t"] == "proc" and recs[0]["pid"] == os.getpid()
    by = {r["name"]: r for r in _spans(recs)}
    assert by["inner"]["parent"] == by["outer"]["sid"]
    assert by["outer"]["attrs"] == {"job": "j"}
    assert by["outer"]["dur"] >= by["inner"]["dur"] >= 0
    inst = [r for r in recs if r["t"] == "inst"]
    assert inst and inst[0]["tid"] == by["outer"]["tid"]
    assert ttm.snapshot()["counters"] == {}   # telemetry off


def test_span_stacks_are_per_thread(tmp_path):
    _tracing_on(tmp_path)
    seen = {}

    def worker():
        seen["bare"] = tr.current_span()
        with tr.span("t2") as s:
            seen["t2"] = s

    def worker2(s1):
        with tr.activate(s1):
            with tr.span("t3") as s:
                seen["t3"] = s

    with tr.span("t1") as s1:
        t = threading.Thread(target=worker)
        t.start()
        t.join(10.0)
        assert tr.current_span() is s1
    t = threading.Thread(target=worker2, args=(s1,))
    t.start()
    t.join(10.0)
    assert not t.is_alive()
    assert seen["bare"] is None and seen["t2"].parent_id is None
    assert seen["t2"].trace_id != s1.trace_id
    assert seen["t3"].trace_id == s1.trace_id
    assert seen["t3"].parent_id == s1.span_id


def test_error_annotation_and_links(tmp_path):
    d = _tracing_on(tmp_path)
    with tr.span("a") as a:
        pass
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("xyz")
    root = tr.start_span("batch", parent=None)
    root.link(a).link(("t" * 32, "s" * 16))
    root.end()
    by = {r["name"]: r for r in _spans(_read(d))}
    assert "xyz" in by["boom"]["attrs"]["error"]
    assert by["batch"]["links"] == [[a.trace_id, a.span_id],
                                    ["t" * 32, "s" * 16]]


def test_traceparent_crosses_packages(tmp_path):
    """The port parses the reference's traceparent and the other way
    round; a malformed header degrades to a local root."""
    good = "00-%s-%s-01" % ("a" * 32, "b" * 16)
    for bad in (None, 7, "", "00-xy-z-01", "00-%s-%s" % ("a" * 32, "b" * 16),
                "00-%s-%s-01" % ("g" * 32, "b" * 16)):
        assert tr.parse_traceparent(bad) is None
        assert jtr.parse_traceparent(bad) is None
    assert tr.parse_traceparent(good) == ("a" * 32, "b" * 16)
    _tracing_on(tmp_path)
    fluid.set_flags({"FLAGS_tracing": True,
                     "FLAGS_telemetry_dir": str(tmp_path / "ref")})
    with jtr.span("ref-client") as c:
        tp = jtr.traceparent()
    with tr.remote_parent(tp):
        child = tr.start_span("port-server")
    child.end()
    assert (child.trace_id, child.parent_id) == (c.trace_id, c.span_id)
    with tr.span("port-client") as pc:
        jbare, jtp = jtr.strip_wire_name(tr.stamp_wire_name("__infer__:r"))
    assert jbare == "__infer__:r" and jtr.parse_traceparent(jtp) == \
        (pc.trace_id, pc.span_id)
    with tr.remote_parent("garbage"):
        s = tr.start_span("orphan")
    assert s.parent_id is None
    s.end()


def test_wire_name_stamp_and_strip(tmp_path):
    _tracing_on(tmp_path)
    assert tr.stamp_wire_name("k") == "k"          # no active span: bare
    with tr.span("s"):
        stamped = tr.stamp_wire_name("__infer__:r9")
        assert stamped == "__infer__:r9\x1f" + tr.traceparent()
        assert tr.strip_wire_name(stamped) == ("__infer__:r9",
                                               tr.traceparent())
    assert tr.strip_wire_name("plain") == ("plain", None)
    assert tr.stamp_wire_name("x" * 990) == "x" * 990  # no room: bare


def test_codec_traceparent_roundtrip():
    from paddle_tpu.serving import codec as jcodec
    from paddle_tpu_torch.serving import codec

    meta = {"model": "m", codec.TRACEPARENT:
            "00-%s-%s-01" % ("c" * 32, "d" * 16)}
    buf = codec.pack(meta)
    np.testing.assert_array_equal(buf, jcodec.pack(meta))
    got, _ = codec.unpack(buf)
    assert tr.parse_traceparent(got[codec.TRACEPARENT]) == \
        ("c" * 32, "d" * 16)


def test_record_span_lays_out_measured_phases(tmp_path):
    d = _tracing_on(tmp_path)
    t0 = time.time() - 0.5
    root = tr.record_span("phase.root", t0, 500.0, epoch=2)
    tr.record_span("phase.a", t0, 300.0, parent=root)
    tr.record_span("phase.b", t0 + 0.3, 200.0, parent=root, links=[root])
    by = {r["name"]: r for r in _spans(_read(d))}
    assert by["phase.a"]["parent"] == by["phase.root"]["sid"]
    assert by["phase.b"]["tid"] == by["phase.root"]["tid"]
    assert by["phase.b"]["links"] == [[root.trace_id, root.span_id]]
    assert by["phase.root"]["dur"] == 500000
    assert abs(by["phase.b"]["ts"] - by["phase.a"]["ts"] - 300000) <= 2


def test_ids_do_not_repeat_across_a_fork():
    code = textwrap.dedent("""
        import os, sys
        sys.path.insert(0, %r)
        from paddle_tpu_torch.core import tracing as tr
        mine = [tr._new_id(8) for _ in range(50)]
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            os.write(w, " ".join(tr._new_id(8) for _ in range(50))
                     .encode())
            os._exit(0)
        os.waitpid(pid, 0)
        child = os.read(r, 1 << 16).decode().split()
        mine += [tr._new_id(8) for _ in range(50)]
        assert len(child) == 50 and len(set(mine)) == 100, child
        assert not set(child) & set(mine)
        print("distinct", len(set(mine) | set(child)))
    """ % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == ["distinct", "150"]


# -- the reference's record layout, key for key ---------------------------------

def _script(m):
    """One sequence of tracing calls through module ``m`` (either
    package's tracing)."""
    with m.span("outer", job="j") as o:
        with m.span("inner", n=1):
            pass
        m.instant("mark", step=3)
        m.note("batch_start", model="fc", req_ids=["r1", "r2"])
    b = m.start_span("batch", rows=2)
    b.link(o).link(None)
    b.end()
    with pytest.raises(ValueError):
        with m.span("boom"):
            raise ValueError("bad")
    m.record_span("rec", time.time() - 1.0, 5.0, parent=o, k=1)
    m.wire_received("__infer__:x", o.traceparent)
    with m.remote_parent(o.traceparent):
        m.start_span("remote_child").end()
    return m.flight_dump(reason="manual")


def _normalize(recs):
    """Ids -> their order of appearance; times dropped."""
    ids = {}

    def nid(v):
        return None if v is None else ids.setdefault(v, len(ids))

    out = []
    for r in recs:
        r = dict(r)
        for k in ("tid", "sid", "parent"):
            if k in r:
                r[k] = nid(r[k])
        if "links" in r:
            r["links"] = [[nid(a), nid(b)] for a, b in r["links"]]
        for k in ("ts", "dur", "pid"):
            if k in r:
                r[k] = type(r[k]).__name__
        if "name" in r and r["t"] == "proc":
            r["name"] = r["name"].startswith("pid-")
        if "attrs" in r and "error" in r["attrs"]:
            r["attrs"] = dict(r["attrs"], error="<error>")
        out.append(r)
    return out


def test_records_have_the_references_layout(tmp_path):
    d = _tracing_on(tmp_path, "port")
    jd = str(tmp_path / "ref")
    fluid.set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": jd})
    port_dump = _script(tr)
    ref_dump = _script(jtr)
    got, want = _read(d), _read(jd)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert _normalize(got) == _normalize(want)
    with open(port_dump) as f:
        pdoc = json.load(f)
    with open(ref_dump) as f:
        jdoc = json.load(f)
    assert sorted(pdoc) == sorted(jdoc) == ["dumped_at", "proc", "reason",
                                            "records"]
    assert pdoc["reason"] == jdoc["reason"] == "manual"
    assert _normalize(pdoc["records"]) == _normalize(jdoc["records"])
    assert os.path.basename(port_dump) == "flightrec-%d.json" % os.getpid()


# -- flight recorder and rotation ---------------------------------------------------

def test_flightrec_dump_on_injected_fault(tmp_path):
    d = _tracing_on(tmp_path)
    with tr.span("work", job="w"):
        tr.note("batch_start", req_ids=["r1", "r2"])
    path = os.path.join(d, "flightrec-%d.json" % os.getpid())
    assert os.path.exists(path)              # note() is write-through
    tfi.arm("rpc.send:error:1")
    assert tfi.maybe_fail("rpc.send") == "error"
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "note:fault"
    kinds = [r.get("kind") for r in doc["records"] if r["t"] == "note"]
    assert kinds == ["batch_start", "fault"]
    fault = doc["records"][-1]
    assert (fault["point"], fault["fault_kind"]) == ("rpc.send", "error")
    assert any(r.get("req_ids") == ["r1", "r2"] for r in doc["records"]
               if r.get("kind") == "batch_start")


def test_flight_ring_is_bounded(tmp_path):
    _tracing_on(tmp_path)
    for i in range(tr._FLIGHT_CAP + 50):
        tr.instant("i%d" % i)
    assert len(tr._flight) == tr._FLIGHT_CAP == 512
    assert tr._flight[-1]["name"] == "i%d" % (tr._FLIGHT_CAP + 49)


def test_trace_jsonl_rotation(tmp_path):
    d = _tracing_on(tmp_path)
    set_flags({"FLAGS_telemetry_max_bytes": 4096})
    for i in range(200):
        tr.instant("filler", i=i, pad="x" * 64)
    path = os.path.join(d, "trace-%d.jsonl" % os.getpid())
    assert os.path.exists(path) and os.path.exists(path + ".1")
    for p in (path, path + ".1"):
        assert os.path.getsize(p) <= 4096
        with open(p) as f:
            for line in f:
                json.loads(line)


def test_tracing_counters_when_telemetry_is_on(tmp_path):
    _tracing_on(tmp_path)
    set_flags({"FLAGS_telemetry": True})
    with tr.span("a"):
        tr.note("n")
    c = ttm.snapshot()["counters"]
    assert c["tracing_records_total{kind=span}"] == 1.0
    assert c["tracing_records_total{kind=note}"] == 1.0
    assert c["tracing_flightrec_dumps_total{reason=note}"] == 1.0


# -- the serving chain in process -----------------------------------------------------

def _serve_in_process(tmp_path):
    """A port ServingServer on the CPU with an fc model ("fc", buckets 1,
    4) and a tiny decoder ("toy") -> (a ServingClient, the server)."""
    sys.path.insert(0, TOOLS)
    from torch_serve import save_demo_decoder, save_demo_model

    from paddle_tpu_torch.serving import (DecodeEngine, ServingClient,
                                          ServingEngine, ServingServer)

    model_dir = str(tmp_path / "model")
    dec_dir = str(tmp_path / "dec")
    if not os.path.exists(model_dir):
        save_demo_model(model_dir)
        save_demo_decoder(dec_dir)
    eng = ServingEngine(buckets=(1, 4), device="cpu")
    eng.add_model("fc", model_dir)
    eng.prewarm()
    dec = DecodeEngine(buckets="2", block_size=4, device="cpu")
    dec.add_model("toy", dec_dir)
    srv = ServingServer(eng, port=0, decode_engine=dec).start()
    return ServingClient(endpoints=["127.0.0.1:%d" % srv.port]), srv


def test_serving_request_full_span_chain(tmp_path):
    """An infer leaves client.infer -> serving.admission ->
    serving.request (-> serving.queue_wait, serving.reply_publish) under
    one trace id; serving.batch links the request span and parents
    serving.pad_to_bucket and serving.execute, under which executor.step
    nests.  A generate leaves client.generate -> serving.admission ->
    serving.request, and every serving.decode_step of it links the
    request span and was noted before it ran."""
    d = _tracing_on(tmp_path)
    cli, srv = _serve_in_process(tmp_path)
    try:
        r = cli.infer("fc", {"x": np.ones((2, 8), np.float32)})
        g = cli.generate("toy", [1, 2, 3], max_new_tokens=4)
        assert r.ok and g.ok, (r.error, g.error)
        assert {"queue_wait_ms", "execute_ms", "bucket", "rows",
                "wire_ms"} <= set(r.phases)
        assert r.phases["bucket"] == 4 and r.phases["rows"] == 2
    finally:
        srv.shutdown()
    recs = _read(d)
    spans = _spans(recs)
    by_sid = {s["sid"]: s for s in spans}

    def chain(root_name):
        root = next(s for s in spans if s["name"] == root_name)
        kids = {}
        for s in spans:
            if s["tid"] == root["tid"]:
                kids.setdefault((s["name"], s["parent"]), s)
        adm = kids[("serving.admission", root["sid"])]
        req = kids[("serving.request", adm["sid"])]
        assert ("serving.queue_wait", req["sid"]) in kids
        assert ("serving.reply_publish", req["sid"]) in kids
        return root, req

    root, req = chain("client.infer")
    assert root["attrs"]["status"] == "ok"
    batch = next(s for s in spans if s["name"] == "serving.batch"
                 and [req["tid"], req["sid"]] in s.get("links", []))
    execute = next(s for s in spans if s["name"] == "serving.execute"
                   and s["parent"] == batch["sid"])
    assert any(s["name"] == "serving.pad_to_bucket"
               and s["parent"] == batch["sid"] for s in spans)
    step = next(s for s in spans if s["name"] == "executor.step"
                and s["parent"] == execute["sid"])
    assert step["tid"] == batch["tid"] and step["attrs"]["cache_hit"]
    assert any(x["t"] == "inst" and x["name"] == "rpc.recv"
               and x["tid"] == root["tid"] for x in recs)
    assert any(x["t"] == "note" and x["kind"] == "batch_start"
               and req["attrs"]["req_id"] in x["req_ids"] for x in recs)

    groot, greq = chain("client.generate")
    steps = [s for s in spans if s["name"] == "serving.decode_step"
             and [greq["tid"], greq["sid"]] in s.get("links", [])]
    # 3 prompt tokens fed and 4 generated, one token a step
    assert len(steps) == 3 + 4 - 1 and greq["attrs"]["tokens"] == 4
    noted = [x["step"] for x in recs if x["t"] == "note"
             and x["kind"] == "decode_step"
             and greq["attrs"]["req_id"] in x["req_ids"]]
    assert noted == sorted(s["attrs"]["step"] for s in steps)
    assert all(by_sid.get(s["parent"]) is None for s in steps)


def test_serving_fault_points(tmp_path):
    """serving.infer / serving.generate / serving.reply "error" answer
    with the reference's error reply; serving.execute.<model> fails
    exactly its firings' batches."""
    cli, srv = _serve_in_process(tmp_path)
    x = {"x": np.ones((1, 8), np.float32)}
    try:
        tfi.arm("serving.infer:error:1:1")
        r = cli.infer("fc", x)
        assert (r.status, r.error) == ("error",
                                       "injected fault: serving.infer")
        assert cli.infer("fc", x).ok
        tfi.arm("serving.generate:error:1:1")
        # unstreamed: a streaming client would wait for chunk 0 until its
        # deadline, then replay
        g = cli.generate("toy", [1, 2], max_new_tokens=2, stream=False)
        assert (g.status, g.error) == ("error",
                                       "injected fault: serving.generate")
        tfi.arm("serving.reply:error:1:1")
        r = cli.infer("fc", x)
        assert (r.status, r.error) == ("error",
                                       "injected fault: serving.reply")
        tfi.arm("serving.execute.fc:error:1:2")
        batches0 = srv.engine.batches
        got = [cli.infer("fc", x) for _ in range(4)]
        assert [r.status for r in got] == ["error", "error", "ok", "ok"]
        assert "injected execute fault (fc)" in got[0].error
        assert srv.engine.batches - batches0 == 2
    finally:
        srv.shutdown()


def test_executor_records_its_steps(tmp_path):
    """One record_step a run: a plan miss then a hit, compile_ms on the
    miss only, the feed and fetch bytes; one executor.step span and one
    step instant a run."""
    from paddle_tpu_torch import framework, layers
    from paddle_tpu_torch.core import Executor, Scope, scope_guard

    d = _tracing_on(tmp_path)
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", shape=[4])
        out = layers.fc(x, 3)
    exe = Executor(framework.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        set_flags({"FLAGS_telemetry": True})
        ttm.reset()
        feed = {"x": np.ones((2, 4), np.float32)}
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[out])
    snap = ttm.snapshot()
    c = snap["counters"]
    assert c["executor_steps_total"] == 2.0
    assert c["executor_cache_miss_total"] == 1.0
    assert c["executor_cache_hit_total"] == 1.0
    assert c["executor_feed_bytes_total"] == 2 * 32
    assert c["executor_fetch_bytes_total"] == 2 * 24
    assert snap["histograms"]["executor_step_ms"]["count"] == 2
    steps = [e for e in ttm._events if e["ev"] == "step"]
    assert [e["cache_hit"] for e in steps] == [False, True]
    assert "compile_ms" in steps[0] and "compile_ms" not in steps[1]
    spans = [s for s in _spans(_read(d)) if s["name"] == "executor.step"]
    assert [s["attrs"]["cache_hit"] for s in spans] == [False, False, True]
    insts = [r for r in _read(d) if r["t"] == "inst" and r["name"] == "step"]
    assert len(insts) == 3


# -- a trace across the two packages ----------------------------------------------------

def _replica(argv, env):
    p = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    return p


def _wait_ready(p, timeout=180.0):
    lines = []
    got = threading.Event()

    def read():
        for line in p.stdout:
            lines.append(line)
            if line.startswith("READY"):
                got.set()
                break
        got.set()

    threading.Thread(target=read, daemon=True).start()
    got.wait(timeout)
    assert lines and lines[-1].startswith("READY"), "".join(lines)[-3000:]
    threading.Thread(target=p.stdout.read, daemon=True).start()
    return int(lines[-1].split()[1].split("=")[1])


def test_a_trace_crosses_the_packages(tmp_path):
    """A reference client against a port replica, then a port client
    against a reference replica: each request's trace id is in the
    client's trace file and the replica's, the replica's admission span
    is a child of the client's root, and trace_view merges the directory
    into one trace with cross-process flows."""
    sys.path.insert(0, TOOLS)
    import trace_view
    from torch_serve import save_demo_model

    from paddle_tpu.serving import ServingClient as JClient
    from paddle_tpu_torch.serving import ServingClient

    d = str(tmp_path / "tel")
    model_dir = save_demo_model(str(tmp_path / "model"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", FLAGS_tracing="1",
               FLAGS_telemetry_dir=d)
    env.pop("XLA_FLAGS", None)
    port_rep = _replica([sys.executable, "-u", os.path.join(
        TOOLS, "torch_serve.py"), "--device", "cpu", "--buckets", "1,4",
        "--model", "fc=" + model_dir], env)
    ref_rep = _replica([sys.executable, "-u", os.path.join(
        TOOLS, "serve.py"), "--buckets", "1,4", "--model",
        "fc=" + model_dir], env)
    x = {"x": np.ones((2, 8), np.float32)}
    try:
        port_ep = "127.0.0.1:%d" % _wait_ready(port_rep)
        ref_ep = "127.0.0.1:%d" % _wait_ready(ref_rep)
        fluid.set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": d})
        assert JClient(endpoints=[port_ep]).infer("fc", x).ok
        jtr.reset()
        fluid.set_flags({"FLAGS_tracing": False})
        set_flags({"FLAGS_tracing": True, "FLAGS_telemetry_dir": d})
        assert ServingClient(endpoints=[ref_ep]).infer("fc", x).ok
        tr.reset()
    finally:
        for p in (port_rep, ref_rep):
            p.terminate()
        for p in (port_rep, ref_rep):
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10)
    assert port_rep.returncode == 0 and ref_rep.returncode == 0
    mine = _spans(_read(d))
    roots = {s["tid"]: s for s in mine if s["name"] == "client.infer"}
    assert len(roots) == 2
    for rep in (port_rep, ref_rep):
        theirs = _spans(_read(d, rep.pid))
        adm = [s for s in theirs if s["name"] == "serving.admission"
               and s["tid"] in roots]
        assert len(adm) == 1, rep.args
        assert adm[0]["parent"] == roots[adm[0]["tid"]]["sid"]
        assert any(s["name"] == "executor.step" for s in theirs)
    procs = trace_view.load_dir(d)
    assert sorted(pid for pid, _n, _r in procs) == sorted(
        [os.getpid(), port_rep.pid, ref_rep.pid])
    names = {pid: n for pid, n, _r in procs}
    assert names[port_rep.pid] == "serving-replica-0"
    trace, flows, _local = trace_view.merge(procs)
    assert flows >= 2
    flow_tids = {e["id"].split(":")[0] for e in trace["traceEvents"]
                 if e.get("ph") == "s"}
    assert set(roots) <= flow_tids
