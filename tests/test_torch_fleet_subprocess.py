"""Two ``tools/torch_serve.py --device cpu`` replicas as a fleet over one
endpoints file, one SIGKILLed mid-traffic (tests/test_serving_fleet_
subprocess.py:65 and tests/test_decode_fleet_subprocess.py:61 re-posed on
the port, with their flight-recorder assertions: the replicas trace, and
the SIGKILLed one must leave a ``flightrec-<pid>.json`` whose
``batch_start`` or ``decode_step`` notes name request ids).

The coordinator must notice the silent replica over the ``__fhb__``
heartbeats, shrink the fleet at a batch boundary and rewrite the file at
a bumped epoch, and the client must fail over so that every request is
answered: the fc outputs equal the JAX predictor's, the decode tokens the
JAX package's ``unpaged_generate`` on the same bundle.  The survivor
prints its ``SERVED`` and ``LAUNCHES`` lines and exits 0 on SIGTERM.  One
replica alone serves the demo bundle with ``--speculative-k 3``, or with
int8 pools from ``FLAGS_kv_cache_dtype``, with the JAX package's tokens.
Every wait is bounded and every process is killed in ``finally``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dist_utils import free_ports, gather_tails

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SERVE = os.path.join(ROOT, "tools", "torch_serve.py")
sys.path.insert(0, os.path.dirname(_SERVE))
from torch_serve import save_demo_decoder, save_demo_model  # noqa: E402


def _env(tel_dir):
    env = dict(os.environ)
    env.update({"FLAGS_telemetry": "1",
                "FLAGS_serving_hb_interval": "0.2",
                "FLAGS_serving_hb_timeout": "3.0",
                "FLAGS_tracing": "1", "FLAGS_telemetry_dir": tel_dir})
    return env


def _wait_ready(proc, timeout=60.0):
    """-> the lines up to READY (the PREWARM manifest among them)."""
    out = []

    def read():
        for line in proc.stdout:
            out.append(line)
            if line.startswith("READY"):
                return

    th = threading.Thread(target=read, daemon=True)
    th.start()
    th.join(timeout)
    if not out or not out[-1].startswith("READY"):
        raise AssertionError("replica not READY:\n" + "".join(out))
    return out


def _wait_file(path, pred, timeout):
    deadline = time.time() + timeout
    doc = None
    while time.time() < deadline:
        try:
            with open(path) as f:
                doc = json.load(f)
            if pred(doc):
                return doc
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError("endpoints file never matched: %r" % (doc,))


def _fleet(tmp_path, models, extra=()):
    """Two replicas serving ``models`` -> (procs, endpoints, file)."""
    eps_file = str(tmp_path / "eps.json")
    eps = ["127.0.0.1:%d" % p for p in free_ports(2)]
    procs = []
    for rank in range(2):
        argv = [sys.executable, "-u", _SERVE, "--device", "cpu",
                "--rank", str(rank), "--fleet", ",".join(eps),
                "--endpoints-file", eps_file] + list(extra)
        for name, d in models:
            argv += ["--model", "%s=%s" % (name, d)]
        procs.append(("replica%d" % rank, subprocess.Popen(
            argv, env=_env(str(tmp_path / "tel")), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)))
    return procs, eps, eps_file


def _start(procs, eps, eps_file):
    for _, p in procs:
        lines = _wait_ready(p)
        pre = [ln for ln in lines if ln.startswith("PREWARM ")]
        assert pre and json.loads(pre[0][8:])["device"] == "cpu"
    # the survivor's output is read at the end; the victim's is drained
    threading.Thread(target=procs[1][1].stdout.read, daemon=True).start()
    _wait_file(eps_file, lambda d: d["endpoints"] == eps, 20.0)


def _kill_and_shrink(victim, eps, eps_file):
    assert victim.wait(10) == -9
    doc = _wait_file(eps_file, lambda d: d["endpoints"] == [eps[0]], 15.0)
    assert doc["epoch"] >= 1


def _postmortem(tmp_path, victim, kind):
    """The SIGKILLed replica's flight record: ``note(kind)`` is written
    through before the batch or step runs, so it names request ids."""
    path = tmp_path / "tel" / ("flightrec-%d.json" % victim.pid)
    assert path.exists(), "the SIGKILLed replica left no flight record"
    doc = json.loads(path.read_text())
    assert doc["proc"]["pid"] == victim.pid
    assert doc["proc"]["name"] == "serving-replica-1"
    notes = [r for r in doc["records"] if r.get("kind") == kind]
    assert notes and all(n.get("req_ids") for n in notes), doc


def _scrape_until(cli, ep, pred, timeout=10.0):
    """The survivor's snapshot once ``pred`` holds (it republishes every
    second)."""
    deadline = time.time() + timeout
    snap = cli.scrape(ep)
    while not pred(snap) and time.time() < deadline:
        time.sleep(0.1)
        snap = cli.scrape(ep)
    assert pred(snap), snap
    return snap


def _terminate_survivor(proc):
    """SIGTERM -> exit 0 after one SERVED and one LAUNCHES line -> the
    SERVED counts."""
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out[-2000:]
    lines = {}
    for ln in out.splitlines():
        key, _, doc = ln.partition(" ")
        if key in ("SERVED", "LAUNCHES"):
            assert key not in lines, out[-2000:]
            lines[key] = json.loads(doc)
    assert sorted(lines) == ["LAUNCHES", "SERVED"], out[-2000:]
    # the CPU takes every kernel's plain version: nothing launched
    assert lines["LAUNCHES"] == {"paged_attention": 0,
                                 "paged_attention_int8": 0,
                                 "flash_attention": 0, "fused_ln": 0,
                                 "layer_norm": 0}
    return lines["SERVED"]


def test_sigkill_replica_drops_no_infer(tmp_path):
    from paddle_tpu.inference import AnalysisConfig, AnalysisPredictor
    from paddle_tpu_torch.serving import ServingClient

    model_dir = save_demo_model(str(tmp_path / "model"))
    procs, eps, eps_file = _fleet(tmp_path, [("fc", model_dir)],
                                  extra=["--buckets", "1,4"])
    try:
        _start(procs, eps, eps_file)
        cli = ServingClient(endpoints_file=eps_file, deadline_ms=15000.0)
        x = np.random.RandomState(0).rand(2, 8).astype(np.float32)
        replies = []

        def stream(n, every_s):
            for _ in range(n):
                replies.append(cli.infer("fc", {"x": x}))
                time.sleep(every_s)

        stream(10, 0.02)
        victim = procs[1][1]
        killer = threading.Timer(0.3, victim.kill)
        killer.start()
        stream(40, 0.05)
        killer.join(10.0)
        _kill_and_shrink(victim, eps, eps_file)
        _postmortem(tmp_path, victim, "batch_start")
        stream(10, 0.02)
        assert [r.status for r in replies] == ["ok"] * 60
        cfg = AnalysisConfig(model_dir)
        cfg.disable_gpu()
        want, = AnalysisPredictor(cfg)._run_feed({"x": x}).values()
        for r in replies:
            out, = r.outputs.values()
            np.testing.assert_allclose(out, np.asarray(want), atol=1e-5)
        _scrape_until(cli, eps[0], lambda s: s["gauges"].get(
            "serving_fleet_size") == 1.0 and s["counters"].get(
            "serving_fleet_evictions_total") == 1.0)
        # the survivor counts the batches it served after READY
        served = _terminate_survivor(procs[0][1])
        assert served["decode_steps"] == 0 and served["encoder_batches"] > 0
    finally:
        gather_tails(procs)


def test_sigkill_mid_decode_drops_nothing(tmp_path):
    from paddle_tpu.serving import decode_model as jdm
    from paddle_tpu_torch.serving import ServingClient

    dec_dir = save_demo_decoder(str(tmp_path / "dec"))
    cfg, params = jdm.load_decoder(dec_dir)
    # the replicas' 16-token blocks gather max_seq rounded up to a block
    pad = -(-cfg.max_seq // 16) * 16
    prompt, max_new = [1, 2, 3], 6
    want = np.asarray(jdm.unpaged_generate(cfg, params, prompt, max_new,
                                           pad_len=pad), np.int32)
    procs, eps, eps_file = _fleet(tmp_path, [("toy", dec_dir)],
                                  extra=["--decode-buckets", "4"])
    try:
        _start(procs, eps, eps_file)
        cli = ServingClient(endpoints_file=eps_file, deadline_ms=15000.0)
        replies, chunks = [], []

        def stream(n, every_s):
            for i in range(n):
                got = []
                replies.append(cli.generate(
                    "toy", prompt, max_new_tokens=max_new,
                    stream=i % 2 == 0,
                    on_token=lambda j, t, got=got: got.append((j, t))))
                chunks.append(got)
                time.sleep(every_s)

        stream(10, 0.02)
        victim = procs[1][1]
        killer = threading.Timer(0.3, victim.kill)
        killer.start()
        stream(20, 0.05)
        killer.join(10.0)
        _kill_and_shrink(victim, eps, eps_file)
        _postmortem(tmp_path, victim, "decode_step")
        stream(10, 0.02)
        assert [r.status for r in replies] == ["ok"] * 40
        for i, (r, got) in enumerate(zip(replies, chunks)):
            np.testing.assert_array_equal(r.outputs["tokens"], want)
            if i % 2 == 0:
                assert got == list(enumerate(want.tolist()))
        _scrape_until(cli, eps[0], lambda s: s["counters"].get(
            "serving_decode_steps_total{model=toy}", 0) > 0)
        # the survivor counts the steps it ran after READY, not its prewarm
        served = _terminate_survivor(procs[0][1])
        assert served["decode_steps"] > 0 and served["encoder_batches"] == 0
    finally:
        gather_tails(procs)


def test_the_replica_refuses_to_fall_back_to_the_cpu(tmp_path):
    """Without a card and without ``--device cpu`` the replica exits
    nonzero; ``--cache-dir`` (a parked ROADMAP item) is refused by name;
    ``--decode-mode int8``, which the reference's replica does not have
    either (int8 KV comes from FLAGS_kv_cache_dtype), and a ``--role``
    other than serve, prefill or decode are argparse's invalid choices,
    as there."""
    model_dir = save_demo_model(str(tmp_path / "model"))
    runs = {"cuda": ["--model", "fc=" + model_dir],
            "cache_dir": ["--device", "cpu", "--cache-dir",
                          str(tmp_path / "cc"), "--model", "fc=" + model_dir],
            "role": ["--device", "cpu", "--role", "router",
                     "--model", "fc=" + model_dir],
            "int8": ["--device", "cpu", "--decode-mode", "int8",
                     "--model", "fc=" + model_dir]}
    for what, argv in runs.items():
        proc = subprocess.run([sys.executable, _SERVE] + argv, cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, what
        assert "READY" not in proc.stdout, what
        want = {"cuda": "CUDA", "int8": "invalid choice",
                "role": "invalid choice"}.get(what, "ROADMAP")
        assert want in proc.stderr, (what, proc.stderr[-2000:])


def _serve_one(tmp_path, model, extra=(), env=None):
    """One ``--device cpu`` replica of ``model`` (NAME, DIR) -> (proc, its
    endpoint) once READY."""
    port, = free_ports(1)
    argv = [sys.executable, "-u", _SERVE, "--device", "cpu", "--port",
            str(port), "--model", "%s=%s" % model] + list(extra)
    proc = subprocess.Popen(argv, env=dict(os.environ, **(env or {})),
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    _wait_ready(proc)
    return proc, "127.0.0.1:%d" % port


@pytest.mark.parametrize("what", ["speculative-k 3",
                                  "FLAGS_kv_cache_dtype=int8"])
def test_replica_serves_speculative_and_int8_with_the_references_tokens(
        tmp_path, what):
    """``--speculative-k 3`` over the demo bundle's draft, and int8 pools
    from ``FLAGS_kv_cache_dtype`` (the reference replica's way to them):
    ``__spec__`` reports them, and the generated tokens are the JAX
    package's (``unpaged_generate`` for the speculative replica; the
    reference's int8 engine for the int8 one).  SIGTERM exits 0."""
    from paddle_tpu import flags as jflags
    from paddle_tpu.serving import DecodeEngine as JDecodeEngine
    from paddle_tpu.serving import decode_model as jdm
    from paddle_tpu_torch.serving import ServingClient

    dec_dir = save_demo_decoder(str(tmp_path / "dec"))
    cfg, params = jdm.load_decoder(dec_dir)
    prompt, max_new = [1, 2, 3], 6
    spec = what.startswith("speculative")
    if spec:
        pad = -(-cfg.max_seq // 16) * 16
        want = np.asarray(jdm.unpaged_generate(cfg, params, prompt, max_new,
                                               pad_len=pad), np.int32)
        extra, env = ["--speculative-k", "3"], None
    else:
        old = jflags.get_flags(["FLAGS_kv_cache_dtype"])
        jflags.set_flags({"FLAGS_kv_cache_dtype": "int8"})
        try:
            ref = JDecodeEngine(buckets="4", deadline_ms=30000.0)
            ref.add_model("toy", (cfg, params), kv_blocks=64)
        finally:
            jflags.set_flags(old)
        ref.start()
        try:
            want = ref.generate("toy", prompt, max_new_tokens=max_new,
                                deadline_ms=30000.0).outputs["tokens"]
        finally:
            ref.stop()
        extra, env = [], {"FLAGS_kv_cache_dtype": "int8"}
    proc, ep = _serve_one(tmp_path, ("toy", dec_dir),
                          ["--decode-buckets", "4"] + extra, env)
    try:
        cli = ServingClient(endpoints=[ep], deadline_ms=15000.0)
        got = cli.spec("toy")
        assert got["speculative_k"] == (3 if spec else 0)
        assert got["kv_dtype"] == ("f32" if spec else "int8")
        assert ("draft" in got) is spec
        chunks = []
        r = cli.generate("toy", prompt, max_new_tokens=max_new, stream=True,
                         on_token=lambda j, t: chunks.append((j, t)))
        assert r.status == "ok", r.error
        np.testing.assert_array_equal(r.outputs["tokens"], want)
        assert chunks == list(enumerate(np.asarray(want).tolist()))
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out[-2000:]
