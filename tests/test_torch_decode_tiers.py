"""SLO tiers and the serving flags on the port's DecodeEngine, held against
the JAX reference's (``paddle_tpu/serving/engine.py``) on the CPU.

* One mixed-tier sequence (paid, free, batch, an unknown tier and
  untiered requests) reaches a full waiting queue of each package's
  engine: both lanes of the demo decoder hold long requests, slowed by
  the ``serving.decode_step`` delay point, so nothing leaves the queue
  while the sequence arrives.  Both engines shed the same requests with
  the same statuses, errors and retry hints, and count the same
  ``serving_tier_shed_total{tier}`` and ``serving_shed_total{reason}``;
  the set equals ``chip_smoke.tier_replay``, the host replay of the
  victim rule (the lowest weight, the newest among equals, goes when the
  arrival outranks it) that the smoke's tiers phase holds the card to.
* A session exported mid-decode carries its own tier and tenant in both
  packages' manifests.
* The 11 serving flags set in a subprocess's environment configure both
  packages' engines alike, and a constructor argument wins in both; a
  ``FLAGS_hbm_budget_bytes`` too small for two blocks raises in both,
  naming the flag.

The demo decoder's widths (``tools/torch_serve.py``); every wait is
bounded.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import telemetry as jtm
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.core import telemetry as ttm
from paddle_tpu_torch.serving import (DecodeEngine, DecoderConfig,
                                      init_decoder_params)
from paddle_tpu_torch.utils import fault_injection as tfi

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import tier_replay  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8, max_seq=48)
PARAMS = init_decoder_params(CFG, seed=7)
BS = 4
LONG = 60000.0
HOLD = "serving.decode_step:delay:1"
WEIGHTS = {"paid": 1.0, "free": 0.45, "batch": 0.15}   # the flag's default
MAX_QUEUE = 4
# arrival order; "gold" is a tier the weights do not name, None untiered
SEQUENCE = ["batch", "free", "gold", "free", "paid", "batch", None, "free",
            "paid", "gold", "paid", "paid"]


def test_replay_of_the_sequence():
    got = tier_replay(SEQUENCE, WEIGHTS, MAX_QUEUE)[0]
    # the unknown tier ties with batch and, newer, goes first; untiered
    # outranks free and batch; a paid arrival meets a queue of weight 1.0
    assert got == {2: ("tier_evicted", "paid"), 5: ("queue_full", "batch"),
                   0: ("tier_evicted", "default"),
                   7: ("queue_full", "free"), 3: ("tier_evicted", "paid"),
                   9: ("queue_full", "gold"), 1: ("tier_evicted", "paid"),
                   11: ("queue_full", "paid")}


@pytest.fixture()
def telemetry_on():
    for tm, setf in ((ttm, set_flags), (jtm, fluid.set_flags)):
        tm.reset()
        setf({"FLAGS_telemetry": True})
    yield
    for tm, setf in ((ttm, set_flags), (jtm, fluid.set_flags)):
        setf({"FLAGS_telemetry": False})
        tm.reset()


def _port_engine(**kw):
    e = DecodeEngine(buckets="2", block_size=BS, deadline_ms=LONG,
                     device="cpu", **kw)
    e.add_model("toy", (CFG, PARAMS), kv_blocks=64)
    return e


def _ref_engine(**kw):
    old = fluid.get_flags(["FLAGS_kv_block_size", "FLAGS_kv_cache_dtype"])
    fluid.set_flags({"FLAGS_kv_block_size": BS,
                     "FLAGS_kv_cache_dtype": "f32"})
    try:
        e = JDecodeEngine(buckets="2", deadline_ms=LONG, **kw)
        e.add_model("toy", (CFG, PARAMS), kv_blocks=64)
    finally:
        fluid.set_flags(old)
    return e


def _wait(what, cond, timeout=60.0):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError("%s did not happen within %.0f s"
                                 % (what, timeout))
        time.sleep(0.005)


def _shed_counts(tm):
    """({tier: sheds}, {reason: sheds}) from a telemetry snapshot."""
    tiers, reasons = {}, {}
    for key, v in tm.snapshot()["counters"].items():
        name, _, labels = key.partition("{")
        lab = dict(p.split("=", 1) for p in labels.rstrip("}").split(",")
                   if p)
        if name == "serving_tier_shed_total":
            tiers[lab["tier"]] = tiers.get(lab["tier"], 0) + v
        elif name == "serving_shed_total":
            reasons[lab["reason"]] = reasons.get(lab["reason"], 0) + v
    return tiers, reasons


def _run_sequence(eng, fi):
    """Both lanes held by long requests, then SEQUENCE -> ([(status,
    error, retry hint > 0, tokens)] in arrival order, the fillers'
    tokens)."""
    eng.start()
    fi.arm(HOLD)
    try:
        fillers = [eng.submit("toy", [1, 2, 3], max_new_tokens=40),
                   eng.submit("toy", [4, 5, 6], max_new_tokens=40)]
        _wait("both lanes busy", lambda: len(eng._active) == 2
              and not eng._waiting)
        reqs = [eng.submit("toy", [7 + i, 8], max_new_tokens=4, tier=t)
                for i, t in enumerate(SEQUENCE)]
        assert len(eng._active) == 2, "a lane freed during the sequence"
        fi.disarm()
        out = []
        for r in reqs:
            rep = r.wait(timeout=120.0)
            assert rep is not None
            out.append((rep.status, rep.error, rep.retry_after_ms > 0,
                        rep.outputs["tokens"].tolist() if rep.ok else None,
                        rep.phases.get("tier")))
        done = [f.wait(timeout=120.0) for f in fillers]
        assert [d.status for d in done] == ["ok", "ok"]
        return out, [d.outputs["tokens"].tolist() for d in done]
    finally:
        fi.disarm()
        eng.stop()


def test_a_full_queue_sheds_the_same_requests_in_both(telemetry_on):
    ref, ref_fill = _run_sequence(_ref_engine(max_queue=MAX_QUEUE), jfi)
    got, got_fill = _run_sequence(_port_engine(max_queue=MAX_QUEUE), tfi)
    assert got == ref
    assert got_fill == ref_fill
    assert _shed_counts(ttm) == _shed_counts(jtm)
    want = tier_replay(SEQUENCE, WEIGHTS, MAX_QUEUE)[0]
    for i, (status, error, hinted, toks, tier) in enumerate(got):
        if i in want:
            reason, by = want[i]
            assert status == "shed" and hinted, (i, status, error)
            assert error == ("evicted by %s-tier arrival" % by
                             if reason == "tier_evicted"
                             else "queue full (%d)" % MAX_QUEUE)
        else:
            assert status == "ok" and len(toks) == 4
            assert tier == (SEQUENCE[i] or "default")
    tiers, reasons = _shed_counts(ttm)
    assert tiers == {"gold": 2.0, "batch": 2.0, "free": 3.0, "paid": 1.0}
    assert reasons == {"tier_evicted": 4.0, "queue_full": 4.0}
    # the completed requests' histograms carry their own tiers
    hist = ttm.snapshot()["histograms"]
    assert {k for k in hist if k.startswith("server_ms{")} == {
        "server_ms{tier=paid}", "server_ms{tier=default}"}


def _export_mid_decode(eng, fi):
    eng.start()
    fi.arm(HOLD)
    try:
        p = eng.submit("toy", [1, 2, 3, 4, 5, 6, 7, 8, 9],
                       max_new_tokens=24, tenant="acme", tier="free")

        def emitted():
            with eng._cond:
                return any(s.pending is p and len(s.out) >= 3
                           for s in eng._active)

        _wait("three tokens emitted", emitted)
        manifest, _payloads = eng.export_session(p.req_id)
        assert eng.abort_migration(p.req_id)
        return manifest
    finally:
        fi.disarm()
        eng.stop()


def test_the_manifest_carries_the_sessions_tier_and_tenant(telemetry_on):
    want = _export_mid_decode(_ref_engine(), jfi)
    got = _export_mid_decode(_port_engine(), tfi)
    assert (got["tier"], got["tenant"]) == (want["tier"], want["tenant"]) \
        == ("free", "acme")


# -- the serving flags -------------------------------------------------------

def _budget_for(blocks, block_size=8):
    """Device bytes holding the demo decoder's weights and ``blocks``
    f32 KV blocks of ``block_size``, plus one byte."""
    from paddle_tpu_torch.serving import KVCacheConfig, block_bytes

    per = block_bytes(KVCacheConfig(CFG.layers, CFG.heads, CFG.head_dim,
                                    block_size, 2))
    resident = sum(int(np.asarray(v).nbytes) for v in PARAMS.values())
    return resident + blocks * per + 1


FLAG_ENV = {
    "FLAGS_serving_buckets": "1,2,8",
    "FLAGS_serving_decode_buckets": "2,3",
    "FLAGS_serving_max_queue": "5",
    "FLAGS_serving_deadline_ms": "1234.5",
    "FLAGS_serving_batch_window_ms": "7.5",
    "FLAGS_serving_decode_mode": "request",
    "FLAGS_serving_tier_weights": "paid:1.0,free:0.5",
    "FLAGS_kv_block_size": "8",
    "FLAGS_kv_cache_blocks": "12",
    "FLAGS_hbm_budget_bytes": str(_budget_for(9)),
    "FLAGS_prefix_cache": "0",
    "FLAGS_decode_prefill_token_budget": "3",
}

# prints the attributes the flags set, with no argument and with every
# argument given; {pkg} is paddle_tpu or paddle_tpu_torch
_PROBE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    from {pkg} import flags
    from {pkg}.serving import DecodeEngine, ServingEngine
    from {pkg}.serving import decode_model as dm
    torch_port = {pkg!r} == "paddle_tpu_torch"
    kw = {{"device": "cpu"}} if torch_port else {{}}
    cfg = dm.DecoderConfig(vocab=31, layers=2, heads=2, head_dim=8,
                           max_seq=48)
    params = {{k: np.asarray(v) for k, v in
              dm.init_decoder_params(cfg, seed=7).items()}}

    def attrs(enc, dec, m):
        return {{"buckets": list(enc.buckets), "max_queue": enc.max_queue,
                "deadline_ms": enc.default_deadline_ms,
                "batch_window_ms": enc.batch_window_ms,
                "tier_weights": enc.tier_weights,
                "decode_buckets": list(dec.buckets),
                "decode_max_queue": dec.max_queue,
                "decode_deadline_ms": dec.default_deadline_ms,
                "mode": dec.mode, "decode_tier_weights": dec.tier_weights,
                "block_size": m.kv_config.block_size,
                "pool_blocks": m.kv_config.num_blocks,
                "prefix_cache": m.prefix is not None,
                "prefill_budget": getattr(dec, "prefill_token_budget",
                                          flags.flag(
                                              "decode_prefill_token_budget"))}}

    dec = DecodeEngine(**kw)
    got = {{"flags": attrs(ServingEngine(**kw), dec,
                          dec.add_model("toy", (cfg, params)))}}
    dec = DecodeEngine(buckets="4", max_queue=7, deadline_ms=99.0,
                       mode="token", **kw)
    got["args"] = attrs(ServingEngine(buckets="1,3", max_queue=11,
                                      deadline_ms=55.0, batch_window_ms=0.5,
                                      **kw), dec,
                        dec.add_model("toy", (cfg, params), kv_blocks=5))
    if torch_port:
        dec = DecodeEngine(block_size=4, prefix_cache=True,
                           prefill_token_budget=0, **kw)
        m = dec.add_model("toy", (cfg, params))
        got["port_args"] = {{"block_size": m.kv_config.block_size,
                            "prefix_cache": m.prefix is not None,
                            "prefill_budget": dec.prefill_token_budget}}
    print("ATTRS " + json.dumps(got, sort_keys=True))
""")


def _probe(pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **FLAG_ENV)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, pkg=pkg)], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    line, = [ln for ln in out.stdout.splitlines() if ln.startswith("ATTRS ")]
    return json.loads(line[len("ATTRS "):])


def test_the_serving_flags_configure_both_engines_alike():
    ref, got = _probe("paddle_tpu"), _probe("paddle_tpu_torch")
    assert got["flags"] == ref["flags"]
    assert got["flags"] == {
        "buckets": [1, 2, 8], "max_queue": 5, "deadline_ms": 1234.5,
        "batch_window_ms": 7.5,
        "tier_weights": {"paid": 1.0, "free": 0.5},
        "decode_buckets": [2, 3], "decode_max_queue": 5,
        "decode_deadline_ms": 1234.5, "mode": "request",
        "decode_tier_weights": {"paid": 1.0, "free": 0.5},
        "block_size": 8, "pool_blocks": 9, "prefix_cache": False,
        "prefill_budget": 3}
    # every constructor argument wins over its flag, in both
    assert got["args"] == ref["args"]
    assert {k: got["args"][k] for k in (
        "buckets", "max_queue", "deadline_ms", "batch_window_ms",
        "decode_buckets", "decode_max_queue", "decode_deadline_ms", "mode",
        "pool_blocks")} == {
        "buckets": [1, 3], "max_queue": 11, "deadline_ms": 55.0,
        "batch_window_ms": 0.5, "decode_buckets": [4],
        "decode_max_queue": 7, "decode_deadline_ms": 99.0, "mode": "token",
        "pool_blocks": 5}
    # the port's engine also takes the flags the reference reads in
    # add_model or at each step as arguments
    assert got["port_args"] == {"block_size": 4, "prefix_cache": True,
                                "prefill_budget": 0}


def test_a_budget_too_small_raises_in_both_naming_the_flag():
    small = _budget_for(1, block_size=BS)
    old = fluid.get_flags(["FLAGS_hbm_budget_bytes", "FLAGS_kv_block_size"])
    fluid.set_flags({"FLAGS_hbm_budget_bytes": small,
                     "FLAGS_kv_block_size": BS})
    set_flags({"FLAGS_hbm_budget_bytes": small})
    try:
        with pytest.raises(ValueError, match="FLAGS_hbm_budget_bytes=%d"
                           % small) as ref:
            JDecodeEngine(buckets="2").add_model("toy", (CFG, PARAMS))
        with pytest.raises(ValueError, match="FLAGS_hbm_budget_bytes=%d"
                           % small) as got:
            DecodeEngine(buckets="2", block_size=BS, device="cpu") \
                .add_model("toy", (CFG, PARAMS))
        assert str(got.value) == str(ref.value)
    finally:
        fluid.set_flags(old)
        set_flags({"FLAGS_hbm_budget_bytes": 0})


# -- the tier over the wire --------------------------------------------------

def test_the_tier_rides_the_wire_and_the_pair(telemetry_on):
    """``ServingClient.generate(tier=)`` reaches the decode engine through a
    serve-role server, and through a prefill replica's hand-off and the
    decode half's commit."""
    from paddle_tpu_torch.serving import (ServingClient, ServingEngine,
                                          ServingServer)

    def ep(srv):
        return "127.0.0.1:%d" % srv.port

    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]      # two blocks of 4 hand off
    srv = ServingServer(ServingEngine(device="cpu"), port=0,
                        decode_engine=_port_engine()).start()
    try:
        cli = ServingClient(endpoints=[ep(srv)], tenant="acme")
        got = [cli.generate("toy", prompt, max_new_tokens=4, tier=t)
               for t in ("free", None)]
    finally:
        srv.shutdown()
    assert [(r.status, r.phases["tier"]) for r in got] == [
        ("ok", "free"), ("ok", "default")]
    sd = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=_port_engine(), role="decode").start()
    sp = ServingServer(ServingEngine(device="cpu"), port=0,
                       decode_engine=_port_engine(), role="prefill",
                       decode_peers=[ep(sd)]).start()
    try:
        cli = ServingClient(endpoints=[ep(sp), ep(sd)],
                            roles=["prefill", "decode"])
        r = cli.generate("toy", prompt, max_new_tokens=4, tier="paid")
    finally:
        sp.shutdown()
        sd.shutdown()
    assert (r.status, r.phases["tier"], r.phases.get("role")) == \
        ("ok", "paid", "disagg")
    assert np.array_equal(r.outputs["tokens"], got[0].outputs["tokens"])
    hist = ttm.snapshot()["histograms"]
    assert {"server_ms{tier=free}", "server_ms{tier=paid}",
            "server_ms{tier=default}"} <= set(hist)
