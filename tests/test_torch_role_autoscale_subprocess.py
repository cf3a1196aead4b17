"""``tools/torch_serve.py --autoscale`` over a role column on the CPU: one
AutoScaler a role, each touching its own role's slots alone.

A three-slot fleet ``--roles decode,decode,prefill``: rank 0 (decode,
the coordinator, ``--autoscale``) and rank 2 (prefill) start, slot 1
stays dead.  The decode pools are small (``FLAGS_kv_cache_blocks`` in the
replicas' environment) and a ``serving.decode_step`` delay slows every
step, so a burst of long generates keeps rank 0's KV pool nearly full:
the decode controller forks a standby into slot 1, the decode slot, and
once the traffic stops retires a decode rank through a drain.  The
prefill replica is in every version of the endpoints file.  Every reply
is ok and every streamed index arrives once.  A unit test holds the slot
choice on a stub fleet.

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

from dist_utils import free_ports, kill_proc_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SERVE = os.path.join(ROOT, "tools", "torch_serve.py")
sys.path.insert(0, os.path.dirname(_SERVE))
from torch_serve import save_demo_decoder, start_autoscaler  # noqa: E402

ROLES = ("decode", "decode", "prefill")
ENV = {"FLAGS_telemetry": "1",
       "FLAGS_serving_hb_interval": "0.2",
       "FLAGS_serving_hb_timeout": "2.0",
       "FLAGS_serving_fleetmon_interval": "0.3",
       "FLAGS_serving_autoscale_interval": "0.2",
       "FLAGS_serving_scale_up_ticks": "2",
       "FLAGS_serving_scale_down_ticks": "10",
       "FLAGS_serving_autoscale_cooldown": "3",
       # 23 usable blocks of 4 tokens: four clients' sequences want 37-48
       "FLAGS_kv_block_size": "4",
       "FLAGS_kv_cache_blocks": "24",
       "FLAGS_fault_spec": "serving.decode_step:delay:1"}
CLIENTS = 4
PROMPT_LEN = 9          # two full blocks handed off by the prefill replica
# client k asks for 24 + 4k tokens, so the clients drift apart and the
# pool stays full rather than emptying in step
MAX_NEW = 24


class _StubFleet:
    """What the scaling closures read of a ``ServingFleet``."""

    def __init__(self, live, roles, rank=0):
        self.live = set(live)
        self.roles = list(roles)
        self.endpoints = ["127.0.0.1:%d" % (9000 + r)
                          for r in range(len(roles))]
        self.rank = rank
        self.retired, self.relaunched = [], []

    def is_coordinator(self):
        return True

    def role_of(self, rank):
        return self.roles[rank]

    def live_role_ranks(self, role):
        return [r for r in sorted(self.live) if self.roles[r] == role]

    def live_role_endpoints(self, role):
        return [self.endpoints[r] for r in self.live_role_ranks(role)]

    def retire(self, rank):
        self.retired.append(rank)

    def notice_relaunch(self, rank):
        self.relaunched.append(rank)


class _Args:
    min_replicas = 1
    max_replicas = 2


class _Engine:
    _queue = []


def test_each_role_scales_its_own_slots(monkeypatch):
    import torch_serve

    forked = []

    class _Popen:
        def __init__(self, argv, **_kw):
            forked.append(argv[argv.index("--rank") + 1])

        def poll(self):
            return None

    monkeypatch.setattr(torch_serve.subprocess, "Popen", _Popen)
    fleet = _StubFleet({0, 1, 2}, ROLES)
    scalers = start_autoscaler(_Args, fleet, _Engine, None, None,
                               roles=list(ROLES))
    for s in scalers:
        s.stop()
    prefill, decode = scalers
    # the role-less choice would retire rank 2, the only prefill replica
    decode.scale_down_fn()
    assert fleet.retired == [1]
    # an idle prefill controller never goes below its one replica
    prefill.metrics_fn = lambda: {"queue_depth": 0.0}
    assert not any(prefill.tick() for _ in range(4 * prefill.down_ticks))
    assert fleet.retired == [1]
    fleet.live = {0, 2}
    prefill.scale_up_fn()            # no dead prefill slot: nothing forks
    decode.scale_up_fn()
    assert fleet.relaunched == [1] and forked == ["1"]
    # the standby still starting holds its slot and counts as a replica
    assert decode.replicas_fn() == 2 and prefill.replicas_fn() == 1
    decode.scale_up_fn()
    assert forked == ["1"]


def _doc(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wait(what, cond, timeout, step=0.05):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError("%s did not happen within %.0f s"
                                 % (what, timeout))
        time.sleep(step)


def test_the_decode_controller_scales_decode_slots_alone(tmp_path):
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import ServingClient

    dec_dir = save_demo_decoder(str(tmp_path / "dec"))
    eps_file = str(tmp_path / "eps.json")
    eps = ["127.0.0.1:%d" % p for p in free_ports(3)]
    base = [sys.executable, "-u", _SERVE, "--device", "cpu", "--model",
            "toy=" + dec_dir, "--fleet", ",".join(eps), "--roles",
            ",".join(ROLES), "--endpoints-file", eps_file]
    procs, lines = {}, {0: [], 2: []}
    for r, extra in ((0, ["--autoscale", "--min-replicas", "1",
                          "--max-replicas", "2"]), (2, [])):
        procs[r] = subprocess.Popen(
            base + ["--rank", str(r)] + extra, env=dict(os.environ, **ENV),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)

    def read(r):
        for line in procs[r].stdout:
            lines[r].append(line.rstrip("\n"))

    readers = [threading.Thread(target=read, args=(r,), daemon=True)
               for r in procs]
    for th in readers:
        th.start()

    def prefixed(r, prefix):
        return [ln[len(prefix):] for ln in list(lines[r])
                if ln.startswith(prefix)]

    versions, watching = [], threading.Event()

    def watch():
        while not watching.is_set():
            d = _doc(eps_file)
            if d is not None and (not versions or d != versions[-1]):
                versions.append(d)
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    stop = threading.Event()
    replies = []
    # a shed under a full pool is retried after its hint
    set_flags({"FLAGS_serving_client_shed_retries": 200})
    try:
        _wait("both READY", lambda: prefixed(0, "READY ") and
              prefixed(2, "READY "), 120.0)
        watcher.start()
        _wait("slot 1 out of the file", lambda: (_doc(eps_file) or {}).get(
            "endpoints") == [eps[0], eps[2]], 30.0)

        def client(k):
            rng = np.random.RandomState(k)
            cli = ServingClient(endpoints_file=eps_file, deadline_ms=60000.0)
            while not stop.is_set():
                prompt = rng.randint(0, 31, PROMPT_LEN).tolist()
                got = []
                r = cli.generate("toy", prompt, max_new_tokens=MAX_NEW + 4 * k,
                                 on_token=lambda i, t: got.append(i),
                                 max_attempts=400)
                replies.append((r, got, MAX_NEW + 4 * k))

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(CLIENTS)]
        for th in threads:
            th.start()
        _wait("the standby's READY", lambda: len(prefixed(0, "READY ")) == 2,
              60.0)
        standby = prefixed(0, "READY ")[1]
        assert standby.split()[0] == "port=" + eps[1].rsplit(":", 1)[1]

        def standby_served():
            if any(json.loads(s)["decode_steps"] > 0
                   for s in prefixed(0, "SERVED ")):
                return True          # served, and retired already
            try:
                return sum(v for k, v in telemetry.scrape(
                    eps[1])["counters"].items() if k.startswith(
                        "serving_decode_requests_total{")) > 0
            except Exception:  # between a retire and a new fork
                return False

        _wait("the standby serving", standby_served, 30.0, step=0.2)
        stop.set()
        for th in threads:
            th.join(120.0)
        assert not any(th.is_alive() for th in threads)
        # idle: the decode controller retires the standby through a drain
        # (every standby forked prints SERVED as it leaves)
        _wait("the standbys retired", lambda: len(prefixed(0, "SERVED "))
              == len(prefixed(0, "READY ")) - 1, 60.0)
        _wait("the file back to ranks 0 and 2", lambda: (
            _doc(eps_file) or {}).get("endpoints") == [eps[0], eps[2]],
              20.0)

        def events():
            c = telemetry.scrape(eps[0])["counters"]
            return (c.get("autoscale_events_total{dir=up}", 0),
                    c.get("autoscale_events_total{dir=down}", 0))

        # __metrics__ republishes on its own tick
        _wait("both scaling events in __metrics__", lambda: min(events())
              >= 1, 10.0, step=0.2)
        served = [json.loads(s) for s in prefixed(0, "SERVED ")]
        assert {s["rank"] for s in served} == {1}
        assert any(s["decode_steps"] > 0 for s in served)
        bad = [(r.status, r.error, len(got), n) for r, got, n in replies
               if r.status != "ok" or len(got) != n
               or got != list(range(len(r.outputs["tokens"])))]
        assert replies and not bad, bad[:3]
        assert procs[2].poll() is None
        for r in (0, 2):
            procs[r].send_signal(signal.SIGTERM)
            assert procs[r].wait(30) == 0
        assert json.loads(prefixed(0, "SERVED ")[-1])["rank"] == 0
        assert [json.loads(s)["rank"] for s in prefixed(2, "SERVED ")] \
            == [2]
        watching.set()
        watcher.join(5.0)
        assert len(versions) >= 3 and all(
            eps[2] in d["endpoints"] and d["roles"][
                d["endpoints"].index(eps[2])] == "prefill" for d in versions)
    finally:
        stop.set()
        watching.set()
        set_flags({"FLAGS_serving_client_shed_retries": 2})
        for p in procs.values():
            kill_proc_tree(p)
        for ln in prefixed(0, "READY ")[1:]:
            try:
                os.killpg(int(ln.split("pid=")[1]), signal.SIGKILL)
            except OSError:
                pass
