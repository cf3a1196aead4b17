"""The port's serving fleet (paddle_tpu_torch/serving/fleet.py) with
in-process replicas on the CPU, and mixed fleets of one JAX-package
replica and one port replica.

Two ``ServingServer`` replicas on localhost ports, each with a
``ServingFleet`` over one endpoints file:

* the coordinator publishes the view with both endpoints;
* a replica stopped without a retire is evicted after the heartbeat
  timeout, and the shrunken view is published only at a batch boundary
  of the serving engine and of the decode engine, at a bumped epoch; client traffic across the eviction is all ok;
* after the coordinator is lost, rank 1 promotes itself and rewrites the
  file; a relaunched rank rejoins, and the coordinator's rollout reaches
  it within a re-broadcast;
* ``retire`` drops the rank from the view before it drains;
* a mixed fleet agrees on its view, and either package's replica promotes
  itself when the other stops.

Heartbeats every 0.2 s and a 3 s timeout, so a loaded CPU never evicts a
live replica; every wait is bounded and every server shuts down in
``finally``.
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from dist_utils import free_ports
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ServingFleet as JFleet
from paddle_tpu.serving import ServingServer as JServer
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      RolloutController, ServingClient,
                                      ServingEngine, ServingFleet,
                                      ServingServer, codec,
                                      init_decoder_params)
from paddle_tpu_torch.serving.fleet import FLEET_VIEW, write_endpoints_file
from paddle_tpu_torch.native import rpc as trpc

HB = {"FLAGS_serving_hb_interval": 0.2, "FLAGS_serving_hb_timeout": 3.0}
X = np.ones((2, 8), np.float32)


@pytest.fixture(autouse=True)
def _heartbeats():
    set_flags(HB)
    fluid.set_flags(HB)
    yield
    dflt = {"FLAGS_serving_hb_interval": 0.3, "FLAGS_serving_hb_timeout": 2.0}
    set_flags(dflt)
    fluid.set_flags(dflt)


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


class _Rig:
    """``kinds[r]`` ("port" or "ref") is rank r's package; ``start(r)``
    launches rank r's server and fleet on its fixed port."""

    def __init__(self, fc_dir, path, kinds):
        self.fc_dir = fc_dir
        self.path = path
        self.kinds = list(kinds)
        self.ports = free_ports(len(kinds))
        self.eps = ["127.0.0.1:%d" % p for p in self.ports]
        self.servers = [None] * len(kinds)
        # each rank's routes as it launched, before its server could take
        # a rollout broadcast
        self.launch_routes = [None] * len(kinds)

    def start(self, r, rollout=False, decode=False):
        dec = None
        if self.kinds[r] == "port":
            eng = ServingEngine(buckets=(1, 4), device="cpu")
            server_cls, fleet_cls = ServingServer, ServingFleet
            if decode:
                cfg = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8,
                                    max_seq=48)
                dec = DecodeEngine(buckets="2", block_size=4, device="cpu")
                dec.add_model("toy", (cfg, init_decoder_params(cfg, seed=7)))
        else:
            eng = JServingEngine(buckets=(1, 4))
            server_cls, fleet_cls = JServer, JFleet
        eng.add_model("fc", self.fc_dir)
        eng.add_model("fc@v2", self.fc_dir)
        eng.prewarm()
        self.launch_routes[r] = eng.routes()
        deadline = time.time() + 10.0
        while True:             # a just-freed port may take a moment
            try:
                srv = server_cls(eng, port=self.ports[r], rank=r,
                                 decode_engine=dec).start()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        self.servers[r] = srv
        fleet = fleet_cls(r, self.eps, srv, endpoints_file=self.path)
        fleet.start()
        if rollout:
            srv.rollout = RolloutController(srv, fleet,
                                            interval_s=0.3).start()
        return srv

    def stop(self, r):
        """Stop rank r without a retire, as a crash would."""
        srv, self.servers[r] = self.servers[r], None
        if srv is not None:
            srv.shutdown()

    def doc(self):
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"epoch": -1, "endpoints": []}

    def wait_doc(self, pred, timeout=20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            d = self.doc()
            if pred(d):
                return d
            time.sleep(0.05)
        raise AssertionError("endpoints file never matched: %r"
                             % (self.doc(),))

    def close(self):
        for r in range(len(self.servers)):
            self.stop(r)


@contextlib.contextmanager
def _rig(fc_dir, tmp_path, kinds=("port", "port"), rollout=False,
         decode=False):
    rig = _Rig(fc_dir, str(tmp_path / "eps.json"), kinds)
    try:
        for r in range(len(kinds)):
            rig.start(r, rollout=rollout, decode=decode)
        rig.wait_doc(lambda d: d["endpoints"] == rig.eps)
        yield rig
    finally:
        rig.close()


def _wait_state(cli, ep, want, timeout=10.0):
    """Wait (bounded) until ``ep`` reports the rollout routes ``want``."""
    deadline = time.time() + timeout
    while time.time() < deadline and cli.rollout_state(ep) != want:
        time.sleep(0.05)
    assert cli.rollout_state(ep) == want


def test_view_published_with_two_endpoints(fc_dir, tmp_path):
    with _rig(fc_dir, tmp_path) as rig:
        doc = rig.doc()
        assert doc == {"epoch": 0, "endpoints": rig.eps}
        coord, follower = rig.servers
        assert coord.fleet.is_coordinator()
        assert not follower.fleet.is_coordinator()
        assert coord.fleet.view() == {"epoch": 0, "live": [0, 1],
                                      "coordinator": 0, "retiring": []}
        cli = ServingClient(endpoints_file=rig.path)
        assert cli.alive(rig.eps[0]) == [0, 0, 1]
        assert cli.alive(rig.eps[1]) == [1, 0, 0]
        assert trpc.probe(rig.eps[0], key=FLEET_VIEW).tolist() == [0, 0, 1]
        # heartbeats keep the follower in the view past the timeout
        time.sleep(HB["FLAGS_serving_hb_timeout"] + 0.5)
        assert rig.doc()["endpoints"] == rig.eps
        assert sorted(coord.fleet.live) == [0, 1]


@pytest.mark.parametrize("busy", ["engine", "decode_engine"])
def test_eviction_publishes_only_at_a_batch_boundary(fc_dir, tmp_path, busy):
    with _rig(fc_dir, tmp_path, decode=busy == "decode_engine") as rig:
        coord = rig.servers[0]
        eng = getattr(coord, busy)
        eng.in_batch = True                 # a batch or decode step runs
        rig.stop(1)
        deadline = time.time() + 15.0
        while time.time() < deadline and 1 in coord.fleet.live:
            time.sleep(0.05)
        assert sorted(coord.fleet.live) == [0]
        time.sleep(1.0)                      # ticks run, the batch does not end
        assert rig.doc() == {"epoch": 0, "endpoints": rig.eps}
        eng.in_batch = False                 # the batch boundary
        doc = rig.wait_doc(lambda d: d["endpoints"] == [rig.eps[0]],
                           timeout=5.0)
        assert doc["epoch"] == 1
        assert trpc.probe(rig.eps[0], key=FLEET_VIEW).tolist() == [1, 0]


def test_client_traffic_across_an_eviction_is_all_ok(fc_dir, tmp_path):
    with _rig(fc_dir, tmp_path) as rig:
        cli = ServingClient(endpoints_file=rig.path, deadline_ms=15000.0)
        replies = []

        def stream(n):
            for _ in range(n):
                replies.append(cli.infer("fc", {"x": X}))
                time.sleep(0.05)

        stream(6)
        killer = threading.Timer(0.3, rig.stop, args=(1,))
        killer.start()
        stream(30)
        killer.join(10.0)
        doc = rig.wait_doc(lambda d: d["endpoints"] == [rig.eps[0]])
        assert doc["epoch"] >= 1
        stream(6)
        assert [r.status for r in replies] == ["ok"] * 42
        assert all(r.outputs[list(r.outputs)[0]].shape == (2, 4)
                   for r in replies)


def test_rank1_promotes_when_the_coordinator_is_lost(fc_dir, tmp_path):
    with _rig(fc_dir, tmp_path) as rig:
        rig.stop(0)
        doc = rig.wait_doc(lambda d: d["endpoints"] == [rig.eps[1]])
        assert doc["epoch"] >= 1
        survivor = rig.servers[1]
        assert survivor.fleet.is_coordinator()
        assert ServingClient(endpoints=[rig.eps[1]]).alive(rig.eps[1])[2] \
            == 1
        assert ServingClient(endpoints_file=rig.path).infer(
            "fc", {"x": X}).ok


def test_a_relaunched_rank_rejoins_and_converges_on_the_rollout(
        fc_dir, tmp_path):
    with _rig(fc_dir, tmp_path, rollout=True) as rig:
        cli = ServingClient(endpoints_file=rig.path)
        got = cli.rollout({"op": "start", "model": "fc", "active": "fc",
                           "canary": "fc@v2", "fraction": 0.25})
        assert got["status"] == "ok"
        assert cli.rollout({"op": "flip", "model": "fc"})["status"] == "ok"
        want = {"models": {"fc": {"active": "fc@v2", "canary": None,
                                  "fraction": 0.0, "state": "flipped"}}}
        doc = rig.wait_doc(lambda d: d.get("rollout") == want)
        # the peer applies __rollout_set__ on its own poll loop, so the
        # file may show the flip a moment before rank 1 does
        _wait_state(cli, rig.eps[1], want)
        rig.stop(1)
        shrunk = rig.wait_doc(lambda d: d["endpoints"] == [rig.eps[0]])
        assert shrunk["epoch"] > doc["epoch"]
        rig.start(1, rollout=True)
        # it launches with no route; reading its engine now would race
        # the coordinator's re-broadcast
        assert rig.launch_routes[1] == {}
        back = rig.wait_doc(lambda d: d["endpoints"] == rig.eps)
        assert back["epoch"] > shrunk["epoch"]
        _wait_state(cli, rig.eps[1], want)
        r = ServingClient(endpoints=[rig.eps[1]]).infer("fc", {"x": X})
        assert r.ok and r.phases["model"] == "fc@v2"


def test_retire_drops_the_rank_before_it_drains(fc_dir, tmp_path):
    with _rig(fc_dir, tmp_path) as rig:
        coord, follower = rig.servers
        at_retire = {}
        retired = threading.Event()

        def on_retire():
            at_retire["doc"] = rig.doc()
            retired.set()

        follower.on_retire = on_retire
        assert coord.fleet.retire(1) is True
        assert rig.doc()["endpoints"] == [rig.eps[0]]
        assert retired.wait(20.0)
        assert at_retire["doc"]["endpoints"] == [rig.eps[0]]
        assert coord.fleet.view()["retiring"] == [1]
        assert coord.fleet.retire(1) is False     # not live any more
        assert coord.fleet.retire(0) is False     # never itself
        time.sleep(1.0)          # its last heartbeats do not re-add it
        assert rig.doc()["endpoints"] == [rig.eps[0]]
        coord.fleet.notice_relaunch(1)
        rig.wait_doc(lambda d: d["endpoints"] == rig.eps)


@pytest.mark.parametrize("kinds", [("ref", "port"), ("port", "ref")],
                         ids=["ref-coordinates", "port-coordinates"])
def test_a_mixed_fleet_agrees_and_either_side_promotes(fc_dir, tmp_path,
                                                       kinds):
    with _rig(fc_dir, tmp_path, kinds=kinds) as rig:
        coord, follower = rig.servers
        assert coord.fleet.view()["live"] == [0, 1]
        assert follower.fleet.view()["live"] == [0, 1]
        assert coord.fleet.view()["coordinator"] == \
            follower.fleet.view()["coordinator"] == 0
        for kind, ep in zip(kinds, rig.eps):
            # either package's client reads either replica's alive var
            assert trpc.probe(ep, key=codec.ALIVE_KEY) is not None, kind
        cli = ServingClient(endpoints_file=rig.path)
        for ep in rig.eps:
            assert ServingClient(endpoints=[ep]).infer("fc", {"x": X}).ok
        time.sleep(HB["FLAGS_serving_hb_timeout"] + 0.5)
        assert rig.doc()["endpoints"] == rig.eps   # heartbeats cross
        rig.stop(0)
        doc = rig.wait_doc(lambda d: d["endpoints"] == [rig.eps[1]])
        assert doc["epoch"] >= 1
        assert rig.servers[1].fleet.is_coordinator()
        assert cli.infer("fc", {"x": X}).ok


def test_write_endpoints_file_matches_the_reference(tmp_path):
    from paddle_tpu.serving.fleet import write_endpoints_file as j_write

    docs = []
    for i, fn in enumerate((write_endpoints_file, j_write)):
        path = str(tmp_path / ("eps%d.json" % i))
        fn(path, 4, ["a:1", "b:2"], rollout={"models": {}},
           roles=["serve", "serve"])
        with open(path) as f:
            docs.append(f.read())
        fn(path, 5, ["a:1"])
        with open(path) as f:
            docs.append(f.read())
    assert docs[0] == docs[2] and docs[1] == docs[3]
    assert json.loads(docs[1]) == {"epoch": 5, "endpoints": ["a:1"]}


def test_the_disaggregated_roles_raise(fc_dir):
    """A role column that does not parallel the endpoints raises; the
    prefill and decode roles are accepted, and the live endpoints of a
    role are where a prefill replica picks its decode peer."""
    srv = ServingServer(ServingEngine(device="cpu"), port=0)
    try:
        with pytest.raises(ValueError, match="parallel"):
            ServingFleet(0, ["a:1", "b:2"], srv, roles=["serve"])
        fl = ServingFleet(0, ["a:1", "b:2"], srv, roles=["serve", "serve"])
        assert fl.role_of(1) == "serve"
        fl = ServingFleet(0, ["a:1", "b:2", "c:3"], srv,
                          roles=["prefill", "decode", "decode"])
        assert [fl.role_of(r) for r in range(3)] == \
            ["prefill", "decode", "decode"]
        assert fl.live_role_endpoints("decode") == ["b:2", "c:3"]
        assert fl.live_role_ranks("prefill") == [0]
        fl.live.discard(1)
        assert fl.live_role_endpoints("decode") == ["c:3"]
    finally:
        srv.rpc.shutdown()


def test_fleet_monitor_and_fleet_top_over_a_live_fleet(fc_dir, tmp_path,
                                                       capsys):
    """With telemetry on, the coordinator's FleetMonitor merges both
    replicas' ``__metrics__`` into ``__fleet__``; tools/torch_fleet_top.py
    reads that document (``--scrape``) and aggregates on its own
    (``--endpoints-file``)."""
    import os
    import sys

    from paddle_tpu_torch.core import telemetry as ttm
    from paddle_tpu_torch.serving import FleetMonitor

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import torch_fleet_top

    set_flags({"FLAGS_telemetry": True})
    ttm.reset()
    try:
        with _rig(fc_dir, tmp_path) as rig:
            coord = rig.servers[0]
            coord.fleetmon = FleetMonitor(server=coord, fleet=coord.fleet,
                                          endpoints_file=rig.path,
                                          interval_s=0.2).start()
            cli = ServingClient(endpoints_file=rig.path)
            for _ in range(8):
                assert cli.infer("fc", {"x": X}).ok
            # both replicas live in this process and publish its one
            # registry, so the fleet document sums it twice
            key = "serving_requests_total{model=fc,tenant=default}"
            deadline = time.time() + 15.0
            doc = None
            while time.time() < deadline:
                doc = coord.fleetmon.last
                if doc and doc["replicas_up"] == 2 and \
                        doc["counters"].get(key) == 2 * 8:
                    break
                time.sleep(0.1)
            assert doc["replicas_up"] == 2, doc
            assert doc["counters"][key] == 2 * 8
            assert doc["histograms"]["serving_execute_ms{model=fc}"][
                "count"] == 2 * 8
            capsys.readouterr()
            assert torch_fleet_top.main(["--scrape", rig.eps[0], "--once",
                                         "--json"]) == 0
            got = json.loads(capsys.readouterr().out)
            assert got["replicas_up"] == 2
            assert [r["endpoint"] for r in got["replicas"]] == rig.eps
            torch_fleet_top._monitor[0] = None
            assert torch_fleet_top.main(["--endpoints-file", rig.path,
                                         "--once"]) == 0
            text = capsys.readouterr().out
            assert text.startswith("fleet_top") and rig.eps[1] in text
    finally:
        torch_fleet_top._monitor[0] = None
        set_flags({"FLAGS_telemetry": False})
        ttm.reset()
