"""The port's named fault points (``paddle_tpu_torch/utils/
fault_injection.py``) against the reference's
(``paddle_tpu/utils/fault_injection.py``).

``tests/test_fault_injection.py``'s cases re-posed on the port, then the
same spec and seed armed in both packages: the two must fire the same
kinds at the same checks, ``count`` and ``skip`` included, and count the
same ``fault_stats``.  Then the port's call sites: the RPC client's
``rpc.send`` and ``rpc.get`` mapped as the reference maps them and
retried by ``_with_retry``, and ``ckpt.write:kill`` leaving only the temp
file of ``io._atomic_save``.
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.utils import fault_injection as tfi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    set_flags({"FLAGS_fault_spec": "", "FLAGS_telemetry": False})
    fluid.set_flags({"FLAGS_fault_spec": ""})
    tfi.disarm()
    jfi.disarm()
    ttm.reset()


# -- the reference's cases, on the port ---------------------------------------

def test_spec_parse_errors():
    for bad in ("rpc.send:explode:1", "rpc.send:drop",
                "rpc.send:drop:not_a_prob"):
        with pytest.raises(ValueError):
            tfi.arm(bad)


def test_disarmed_is_noop():
    tfi.disarm()
    assert [tfi.maybe_fail("rpc.send") for _ in range(3)] == [None] * 3
    assert tfi.fault_stats() == {}


def test_drop_and_error_kinds_returned():
    tfi.arm("a:drop:1;b:error:1")
    assert tfi.maybe_fail("a") == "drop"
    assert tfi.maybe_fail("b") == "error"
    assert tfi.maybe_fail("c") is None
    assert tfi.fault_stats() == {"a": (1, 1), "b": (1, 1)}


def test_count_limits_firings():
    tfi.arm("p:error:1:2")
    assert [tfi.maybe_fail("p") for _ in range(4)] == [
        "error", "error", None, None]
    assert tfi.fault_stats()["p"] == (4, 2)


def test_skip_defers_first_firing():
    tfi.arm("p:drop:1:1:3")
    assert [tfi.maybe_fail("p") for _ in range(5)] == [
        None, None, None, "drop", None]


def test_delay_sleeps_and_is_a_connection_error_kind():
    tfi.arm("p:delay:1:1")
    t0 = time.monotonic()
    assert tfi.maybe_fail("p") is None
    assert time.monotonic() - t0 >= 0.5 * tfi.DELAY_SECONDS
    assert issubclass(tfi.FaultInjected, ConnectionError)


def test_flag_driven_arming_and_the_counter():
    set_flags({"FLAGS_telemetry": True})
    tfi.disarm()
    set_flags({"FLAGS_fault_spec": "p:error:1:1"})
    assert tfi.maybe_fail("p") == "error"
    assert tfi.maybe_fail("p") is None
    counters = ttm.snapshot()["counters"]
    assert counters["fault_injected_total{kind=error,point=p}"] == 1.0


def test_kill_sigkills_the_process():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        from paddle_tpu_torch.utils import fault_injection as fi
        fi.arm('p:kill:1:1:2')
        for i in range(10):
            fi.maybe_fail('p')
            print('survived', i, flush=True)
    """ % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr)
    assert p.stdout.splitlines() == ["survived 0", "survived 1"]


# -- the same firing sequence as the reference ---------------------------------

SPECS = [
    ("p:drop:0.5", 1234),
    ("p:error:0.3:4", 7),
    ("p:drop:0.7:3:5;q:error:0.5::2", 99),
    ("p:error:1:2:3;q:drop:0.25", 0),
    ("rpc.send:drop:0.4:6:1,rpc.get:error:0.6", 2024),
]


@pytest.mark.parametrize("spec,seed", SPECS)
def test_same_spec_and_seed_fire_as_the_reference(spec, seed):
    rng = np.random.RandomState(seed)
    names = sorted({e.split(":")[0] for e in spec.replace(",", ";")
                    .split(";")} | {"other"})
    order = [names[i] for i in rng.randint(0, len(names), 200)]
    tfi.arm(spec, seed=seed)
    jfi.arm(spec, seed=seed)
    got = [tfi.maybe_fail(n) for n in order]
    want = [jfi.maybe_fail(n) for n in order]
    assert got == want
    assert tfi.fault_stats() == jfi.fault_stats()
    assert any(got) and None in got


def test_flag_armed_specs_fire_as_the_reference():
    spec = "p:drop:1:2:1;q:error:1:1"
    set_flags({"FLAGS_fault_spec": spec})
    fluid.set_flags({"FLAGS_fault_spec": spec})
    tfi.disarm()
    jfi.disarm()
    order = ["p", "q", "p", "p", "q", "p"]
    got = [tfi.maybe_fail(n) for n in order]
    assert got == [jfi.maybe_fail(n) for n in order]
    assert got == [None, "error", "drop", "drop", None, None]


# -- call sites ------------------------------------------------------------------

def _server_frames(n_expected, fn, timeout=30.0):
    """Run ``fn(endpoint)`` against a port RpcServer whose poll thread
    collects SEND frames -> (fn's result, the frames' names)."""
    from paddle_tpu_torch.native import rpc

    srv = rpc.RpcServer(0)
    srv.set_var("v", np.arange(4, dtype=np.float32))
    srv.serve(True)
    names = []

    def poll():
        while True:
            t, name, _arr = srv.poll()
            if t == 0:
                return
            if t == rpc.EV_SEND:
                names.append(name)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        out = fn("127.0.0.1:%d" % srv.port)
        deadline = time.time() + timeout
        while len(names) < n_expected and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
    finally:
        srv.shutdown()
        th.join(10.0)
    assert not th.is_alive()
    return out, names


@pytest.mark.parametrize("kind,frames", [("drop", 1), ("error", 2)])
def test_rpc_send_fault_is_retried(kind, frames):
    """drop: the frame never left, the retry sends it once; error: it was
    delivered and the transport failed after, so the retry replays it."""
    from paddle_tpu_torch.native import rpc

    set_flags({"FLAGS_telemetry": True})
    tfi.arm("rpc.send:%s:1:1" % kind)

    def send(ep):
        c = rpc.RpcClient(ep, connect_timeout=10.0, rpc_deadline=10.0,
                          retry_times=2)
        try:
            c.send_var("x", np.ones(3, np.float32))
        finally:
            c.close()

    _, names = _server_frames(frames, send)
    assert names == ["x"] * frames
    assert tfi.fault_stats()["rpc.send"] == (2, 1)
    counters = ttm.snapshot()["counters"]
    assert counters["rpc_retry_total{op=send_var}"] == 1.0
    assert counters["fault_injected_total{kind=%s,point=rpc.send}"
                    % kind] == 1.0


@pytest.mark.parametrize("kind", ["drop", "error"])
def test_rpc_get_fault_is_retried(kind):
    from paddle_tpu_torch.native import rpc

    tfi.arm("rpc.get:%s:1:2" % kind)

    def get(ep):
        c = rpc.RpcClient(ep, connect_timeout=10.0, rpc_deadline=10.0,
                          retry_times=2)
        try:
            return c.get_var("v")
        finally:
            c.close()

    got, _ = _server_frames(0, get)
    np.testing.assert_array_equal(got, np.arange(4, dtype=np.float32))
    assert tfi.fault_stats()["rpc.get"] == (3, 2)


def test_rpc_fault_without_retries_raises_fault_injected():
    from paddle_tpu_torch.native import rpc

    tfi.arm("rpc.get:drop:1:1")

    def get(ep):
        c = rpc.RpcClient(ep, connect_timeout=10.0, rpc_deadline=10.0,
                          retry_times=0)
        try:
            with pytest.raises(tfi.FaultInjected):
                c.get_var("v")
        finally:
            c.close()

    _server_frames(0, get)


def test_ckpt_write_kill_leaves_only_the_temp_file(tmp_path):
    """``ckpt.write:kill`` fires between the temp write and the rename:
    the process dies with the complete temp file on disk and no torn
    ``__params__.npz``."""
    out = str(tmp_path / "ckpt")
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        from paddle_tpu_torch import framework, io, layers
        from paddle_tpu_torch.core import Executor, Scope, scope_guard
        main, startup = framework.Program(), framework.Program()
        with framework.program_guard(main, startup):
            x = layers.data("x", shape=[4])
            layers.fc(x, 3)
        exe = Executor(framework.CPUPlace())
        with scope_guard(Scope()):
            exe.run(startup)
            io.save_persistables(exe, %r, main_program=main)
        print("saved", flush=True)
    """ % (ROOT, out))
    env = dict(os.environ, FLAGS_fault_spec="ckpt.write:kill:1")
    p = subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    stdout, stderr = p.communicate(timeout=300)
    assert p.returncode == -signal.SIGKILL, (p.returncode, stderr[-2000:])
    assert "saved" not in stdout
    tmp = "__params__.npz._tmp.%d" % p.pid
    assert os.listdir(out) == [tmp]
    with np.load(os.path.join(out, tmp)) as z:
        assert len(z.files) == 2        # the fc's weight and bias, whole
    # disarmed, the same save lands whole
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "__params__.npz" in os.listdir(out)
