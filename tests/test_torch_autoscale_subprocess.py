"""``tools/torch_serve.py --autoscale`` on the CPU: rank 0 of a two-slot
fleet starts alone, a burst of requests forks a ``--device cpu`` standby
into slot 1, the endpoints file grows to both endpoints and the standby
serves; when the traffic stops the coordinator retires it through a drain
and the file shrinks back.  Every request is answered.

The fc model is tiny, so the ``serving.execute.fc:delay:1`` fault point
(a 50-150 ms sleep before each batch, inherited by the standby) is what
makes the queue deep enough to read as pressure.  Every wait is bounded
and every process is killed in ``finally``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from dist_utils import free_ports, kill_proc_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SERVE = os.path.join(ROOT, "tools", "torch_serve.py")
sys.path.insert(0, os.path.dirname(_SERVE))
from torch_serve import child_argv, save_demo_model  # noqa: E402

ENV = {"FLAGS_telemetry": "1",
       "FLAGS_serving_hb_interval": "0.2",
       "FLAGS_serving_hb_timeout": "2.0",
       "FLAGS_serving_fleetmon_interval": "0.3",
       "FLAGS_serving_autoscale_interval": "0.2",
       "FLAGS_serving_scale_up_ticks": "2",
       "FLAGS_serving_scale_down_ticks": "5",
       "FLAGS_serving_autoscale_cooldown": "3",
       "FLAGS_serving_scale_up_depth": "2",
       "FLAGS_fault_spec": "serving.execute.fc:delay:1"}


def _wait(what, cond, timeout, step=0.05):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError("%s did not happen within %.0f s"
                                 % (what, timeout))
        time.sleep(step)


def _endpoints(path):
    try:
        with open(path) as f:
            return json.load(f)["endpoints"]
    except (OSError, ValueError):
        return None


def test_child_argv_drops_the_scaling_options():
    argv = ["--device", "cpu", "--rank", "0", "--autoscale", "--fleet",
            "a,b", "--min-replicas", "1", "--max-replicas=2", "--model",
            "fc=/m"]
    got = child_argv(1, argv)
    assert got[:2] == [sys.executable, _SERVE]
    assert got[2:] == ["--device", "cpu", "--fleet", "a,b", "--model",
                       "fc=/m", "--rank", "1"]


def test_autoscale_forks_a_standby_and_retires_it(tmp_path):
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import ServingClient

    model_dir = save_demo_model(str(tmp_path / "model"))
    eps_file = str(tmp_path / "eps.json")
    eps = ["127.0.0.1:%d" % p for p in free_ports(2)]
    rank0 = subprocess.Popen(
        [sys.executable, "-u", _SERVE, "--device", "cpu", "--rank", "0",
         "--fleet", ",".join(eps), "--endpoints-file", eps_file,
         "--autoscale", "--min-replicas", "1", "--max-replicas", "2",
         "--buckets", "1,4", "--model", "fc=" + model_dir],
        env=dict(os.environ, **ENV), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []

    def read():
        for line in rank0.stdout:
            lines.append(line.rstrip("\n"))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def prefixed(prefix):
        return [json.loads(ln[len(prefix):]) for ln in list(lines)
                if ln.startswith(prefix)]

    def ready_pids():
        return [int(ln.split("pid=")[1]) for ln in list(lines)
                if ln.startswith("READY")]

    stop = threading.Event()
    replies = []
    try:
        _wait("rank 0 READY", lambda: len(ready_pids()) == 1, 120.0)
        _wait("the dead slot 1 evicted", lambda: _endpoints(eps_file)
              == [eps[0]], 20.0)
        x = np.random.RandomState(0).rand(1, 8).astype(np.float32)

        def client():
            cli = ServingClient(endpoints_file=eps_file,
                                deadline_ms=20000.0)
            while not stop.is_set():
                replies.append(cli.infer("fc", {"x": x}))

        threads = [threading.Thread(target=client) for _ in range(8)]
        for th in threads:
            th.start()
        _wait("the standby's READY", lambda: len(ready_pids()) == 2, 120.0)
        _wait("the file listing the standby", lambda: _endpoints(eps_file)
              == eps, 30.0)
        _wait("the standby serving", lambda: any(
            k.startswith("serving_batches_total{")
            for k in telemetry.scrape(eps[1])["counters"]), 30.0, step=0.3)
        stop.set()
        for th in threads:
            th.join(60.0)
        assert not any(th.is_alive() for th in threads)
        _wait("the standby retired", lambda: len(prefixed("SERVED ")) == 1
              and len(prefixed("LAUNCHES ")) == 1, 60.0)
        _wait("the file shrinking back", lambda: _endpoints(eps_file)
              == [eps[0]], 20.0)
        assert replies and [r.status for r in replies] == \
            ["ok"] * len(replies)
        pre = prefixed("PREWARM ")
        assert [p["device"] for p in pre] == ["cpu", "cpu"]
        served, = prefixed("SERVED ")
        assert served["rank"] == 1 and served["encoder_batches"] > 0
        assert prefixed("LAUNCHES ")[0] == {
            "paged_attention": 0, "paged_attention_int8": 0,
            "flash_attention": 0, "fused_ln": 0, "layer_norm": 0}
        snap = telemetry.scrape(eps[0])
        assert snap["counters"]["autoscale_events_total{dir=up}"] == 1.0
        assert snap["counters"]["autoscale_events_total{dir=down}"] >= 1.0
        rank0.send_signal(signal.SIGTERM)
        assert rank0.wait(30) == 0
        reader.join(10.0)
        assert [s["rank"] for s in prefixed("SERVED ")] == [1, 0]
    finally:
        stop.set()
        kill_proc_tree(rank0)
        for pid in ready_pids()[1:]:
            try:
                os.killpg(pid, signal.SIGKILL)
            except OSError:
                pass
