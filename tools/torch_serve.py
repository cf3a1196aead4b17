"""One serving replica of the PyTorch port (``paddle_tpu_torch.serving``).

Usage:
    # one replica, two models, every bucket warmed, on the card
    python tools/torch_serve.py --model fc=/path/to/model \
        --model bert=/path/to/bert --port 9000 --buckets 1,4,16

    # a fleet of N replicas: run once per replica with the SAME --fleet
    # list; the coordinator (the lowest live rank) keeps --endpoints-file
    # current for the clients' failover
    python tools/torch_serve.py --model fc=/path --rank 0 \
        --fleet 127.0.0.1:9000,127.0.0.1:9001 \
        --endpoints-file /tmp/eps.json

    # a canary version beside its base: route with the client's rollout
    python tools/torch_serve.py --model bert=/path/v1 \
        --model bert@v2=/path/v2 ...

    # decode serving: a --model DIR holding a save_decoder() bundle
    # (decoder.json + params.npz, of either package) goes to the
    # DecodeEngine; a tiny one for smoke tests, bundled with a one-layer
    # draft:
    python tools/torch_serve.py --save-demo-decoder /tmp/dec
    python tools/torch_serve.py --model toy=/tmp/dec --decode-buckets 4,8

    # speculative decode over the bundled draft, k tokens ahead (default
    # FLAGS_speculative_k); int8 KV pools through the flag, as in the
    # reference
    python tools/torch_serve.py --model toy=/tmp/dec --speculative-k 3
    FLAGS_kv_cache_dtype=int8 python tools/torch_serve.py --model toy=/tmp/dec

    # on the CPU (the plain PyTorch path), as the tests run it
    python tools/torch_serve.py --device cpu --model fc=/path

    # a disaggregated pair: a prefill replica streams each sealed prompt
    # block to a decode replica, which generates; the coordinator puts the
    # role column into the endpoints file, and clients send __generate__
    # to the prefill replicas (FLAGS_migrate_on_drain=1: a retired decode
    # replica moves its live sessions to the other instead of finishing
    # them)
    python tools/torch_serve.py --model toy=/tmp/dec --rank 0 \
        --fleet 127.0.0.1:9000,127.0.0.1:9001 --roles prefill,decode \
        --endpoints-file /tmp/eps.json     # and --rank 1 likewise
    # a static pair without a fleet
    python tools/torch_serve.py --model toy=/tmp/dec --port 9001 \
        --role decode
    python tools/torch_serve.py --model toy=/tmp/dec --port 9000 \
        --role prefill --decode-peers 127.0.0.1:9001

    # an autoscaling fleet: start rank 0 alone over a list with spare
    # slots; on sustained queue pressure it forks a standby replica (this
    # command line with --rank K) into the lowest dead slot, and on
    # sustained idle it retires the highest live rank through a drain
    python tools/torch_serve.py --model fc=/path --rank 0 \
        --fleet 127.0.0.1:9000,127.0.0.1:9001 \
        --endpoints-file /tmp/eps.json --autoscale \
        --min-replicas 1 --max-replicas 2

    # with --roles, one autoscaler a role, each forking into and retiring
    # from its own role's slots: decode on KV-pool occupancy (>= 0.85 up,
    # <= 0.30 idle), prefill on queue depth; the serving flags
    # (FLAGS_kv_cache_blocks, FLAGS_serving_max_queue, ...) come from the
    # environment
    FLAGS_kv_cache_blocks=64 python tools/torch_serve.py \
        --model toy=/tmp/dec --rank 0 --autoscale --max-replicas 2 \
        --fleet 127.0.0.1:9000,127.0.0.1:9001,127.0.0.1:9002 \
        --roles decode,decode,prefill --endpoints-file /tmp/eps.json

    # traced, with a fault armed (FLAGS_* from the environment); merge the
    # trace-<pid>.jsonl files of every process with tools/trace_view.py
    FLAGS_tracing=1 FLAGS_telemetry_dir=/tmp/tel \
        FLAGS_fault_spec="serving.execute.fc:error:1:2" \
        python tools/torch_serve.py --model fc=/path

Every (model, bucket) is warmed before the replica takes traffic and
before it joins a fleet; the manifest prints as one ``PREWARM {...}``
line (the device's name under "device"), then ``READY port=N pid=P``.
The replica always runs a RolloutController behind ``__rollout_ctl__``,
and a FleetMonitor (``__fleet__`` on the coordinator) when
FLAGS_telemetry is on and a fleet or an endpoints file is given.  On
SIGTERM or SIGINT, or after a ``__retire__`` drain, it prints one
``SERVED {...}`` line (its rank, and the decode steps and encoder
batches run since READY) and one ``LAUNCHES {...}`` line (the kernel
wrappers' launch counts since READY) and exits 0.  A standby forked by
``--autoscale`` writes to the same output.  With FLAGS_tracing on, the
replica names its track ``serving-replica-<rank>`` and its flight
recorder dumps ``flightrec-<pid>.json`` on SIGTERM too.  Without a card
and without ``--device cpu`` it exits nonzero.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# options of the reference's replica that the port does not have yet, and
# the ROADMAP item that brings each
_NOT_PORTED = {
    "cache_dir": "a compile cache (ROADMAP, parked beside CUDA graphs: "
                 "the port runs eager PyTorch and has no executable to "
                 "persist)",
}


def save_demo_model(dirname, in_dim=8, out_dim=4):
    """A tiny fc softmax model, saved by the port's save_inference_model
    (smoke tests)."""
    from paddle_tpu_torch import framework, io, layers
    from paddle_tpu_torch.core import Executor, Scope, scope_guard

    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", shape=[in_dim])
        h = layers.fc(x, 16, act="relu")
        out = layers.fc(h, out_dim, act="softmax")
    exe = Executor(framework.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        io.save_inference_model(dirname, ["x"], [out], exe,
                                main_program=main)
    return dirname


def save_demo_decoder(dirname, vocab=31, layers=2, heads=2, head_dim=8,
                      max_seq=48, seed=7):
    """A tiny decoder bundle (the reference's demo widths and seed) with a
    first-layer ``truncate_decoder`` draft, so --speculative-k can
    speculate on it."""
    from paddle_tpu_torch.serving import (DecoderConfig, init_decoder_params,
                                          save_decoder, truncate_decoder)

    cfg = DecoderConfig(vocab=vocab, layers=layers, heads=heads,
                        head_dim=head_dim, max_seq=max_seq)
    params = init_decoder_params(cfg, seed=seed)
    return save_decoder(dirname, cfg, params,
                        draft=truncate_decoder(cfg, params, layers=1))


def kernel_wrappers():
    """{kernel: wrapper} of the kernels a serving replica can reach."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ln as fl
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

    return {"paged_attention": pa.paged_attention,
            "paged_attention_int8": pa.paged_attention_int8,
            "flash_attention": fa.flash_attention,
            "fused_ln": fl.fused_ln_fwd,
            "layer_norm": ln.layer_norm_2d}


def kernel_launches():
    """{kernel: launches} of the wrappers a serving replica can reach."""
    return {k: f.launches for k, f in kernel_wrappers().items()}


def child_argv(rank, argv=None):
    """This invocation re-exec'd for fleet slot ``rank``: without
    --autoscale (a standby never scales), --rank, --min-replicas,
    --max-replicas and --role (a standby takes its slot's --roles entry);
    every other option, --device among them, kept."""
    dropped = ("--rank", "--min-replicas", "--max-replicas", "--role")
    out = [sys.executable, os.path.abspath(__file__)]
    it = iter(sys.argv[1:] if argv is None else argv)
    for a in it:
        if a == "--autoscale":
            continue
        if a in dropped:
            next(it, None)
            continue
        if a.split("=", 1)[0] in dropped:
            continue
        out.append(a)
    return out + ["--rank", str(rank)]


def start_autoscaler(args, fleet, engine, decode_engine, monitor,
                     roles=None):
    """The coordinator's AutoScalers over this fleet, as the reference's
    ``tools/serve.py`` runs them -> their list.  Without a role column,
    one: scale-up forks a standby into the lowest dead slot on queue
    depth or sheds, scale-down retires the highest live rank other than
    the coordinator.  With ``roles``, one a role present, each touching
    only its role's slots: prefill on queue depth (>=
    ``FLAGS_serving_scale_up_depth`` up, 0 idle), decode on KV-pool
    occupancy (>= 0.85 up, <= 0.30 idle).  A slot whose forked standby
    is still starting counts as taken, and as a replica of its role, so
    sustained pressure during its prewarm forks nothing more."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import AutoScaler
    from paddle_tpu_torch.serving.fleet import (retire_candidate,
                                                standby_slot)

    children = {}                   # rank -> Popen of the forked standby

    def starting(role=None):
        return {r for r, p in children.items()
                if p.poll() is None and r not in fleet.live
                and (role is None or fleet.role_of(r) == role)}

    def local_depth():
        depth = len(engine._queue)
        if decode_engine is not None:
            depth += len(decode_engine._waiting)
        return depth

    def local_occupancy():
        occ = 0.0
        if decode_engine is not None:
            for m in decode_engine._models.values():
                alloc = m.cache.allocator
                occ = max(occ, alloc.in_use / (float(alloc.capacity) or 1.0))
        return occ

    def scale_up(role):
        def fn():
            if not fleet.is_coordinator():
                return
            rank = standby_slot(fleet, starting(), role)
            if rank is None:
                return
            fleet.notice_relaunch(rank)
            children[rank] = subprocess.Popen(child_argv(rank),
                                              start_new_session=True)
        return fn

    def scale_down(role):
        def fn():
            if not fleet.is_coordinator():
                return
            rank = retire_candidate(fleet, role)
            if rank is not None:
                fleet.retire(rank)
        return fn

    def replicas(role):
        return lambda: len(set(fleet.live_role_ranks(role)
                               if role is not None else fleet.live)
                           | starting(role))

    if roles is None:
        def metrics():
            # the monitor's fleet-windowed view once it has a document,
            # the local queue and shed counter until then
            if monitor is not None:
                m = monitor.autoscale_metrics()
                if m is not None and m.get("replicas_up"):
                    return m
            return {"queue_depth": local_depth(),
                    "shed_total": telemetry.counter_total(
                        "serving_shed_total")}

        return [AutoScaler(
            metrics, scale_up(None), scale_down(None),
            replicas_fn=replicas(None), min_replicas=args.min_replicas,
            max_replicas=args.max_replicas).start()]

    def role_metrics(role):
        def fn():
            # the monitor's view of the role once it has a document; until
            # then a scrape of the role's live peers over __metrics__,
            # this replica adding its own instants
            if monitor is not None:
                m = monitor.autoscale_metrics(role)
                if m is not None and m.get("replicas_up"):
                    return m
            depth = occ = shed = 0.0
            for ep in fleet.live_role_endpoints(role):
                if ep == fleet.endpoints[fleet.rank]:
                    continue
                try:
                    snap = telemetry.scrape(ep, timeout=2.0)
                except Exception:  # a peer leaving: skip it this tick
                    continue
                g = snap.get("gauges", {})
                depth += max((v for k, v in g.items()
                              if k.startswith("serving_queue_depth")),
                             default=0.0)
                occ = max(occ, max((v for k, v in g.items()
                                    if k.startswith("kv_pool_occupancy")),
                                   default=0.0))
                shed += sum(v for k, v in snap.get("counters", {}).items()
                            if k.startswith("serving_shed_total"))
            if fleet.role_of(fleet.rank) == role:
                depth += local_depth()
                shed += telemetry.counter_total("serving_shed_total")
                occ = max(occ, local_occupancy())
            return {"queue_depth": depth, "shed_total": shed,
                    "kv_occupancy": occ}
        return fn

    up_depth = float(flags.flag("serving_scale_up_depth"))

    def prefill_pressure(m):
        d = float(m.get("queue_depth", 0.0))
        return d >= up_depth, d <= 0.0

    def decode_pressure(m):
        occ = float(m.get("kv_occupancy", 0.0))
        return occ >= 0.85, occ <= 0.30

    return [AutoScaler(
        role_metrics(role), scale_up(role), scale_down(role),
        replicas_fn=replicas(role), min_replicas=args.min_replicas,
        max_replicas=args.max_replicas, pressure_fn=pfn).start()
        for role, pfn in (("prefill", prefill_pressure),
                          ("decode", decode_pressure)) if role in roles]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", action="append", default=[],
                    metavar="NAME=DIR",
                    help="register a model (repeatable): a save_decoder "
                    "bundle goes to the DecodeEngine, a "
                    "save_inference_model directory to the ServingEngine; "
                    "NAME@vN is a version beside NAME")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which needs a card; "
                    "cpu runs the plain PyTorch path)")
    ap.add_argument("--port", type=int, default=0,
                    help="RPC port (0 = any free one; printed on READY)")
    ap.add_argument("--buckets", default=None,
                    help="batch buckets of the ServingEngine, e.g. "
                    "1,4,16,64 (default FLAGS_serving_buckets)")
    ap.add_argument("--decode-buckets", default=None,
                    help="lane buckets of the DecodeEngine, e.g. 4,8 "
                    "(default FLAGS_serving_decode_buckets)")
    ap.add_argument("--decode-mode", default=None,
                    choices=("token", "request"),
                    help="token-level continuous batching or the "
                    "request-level baseline (default "
                    "FLAGS_serving_decode_mode; int8 KV pools come from "
                    "FLAGS_kv_cache_dtype)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV pool size in blocks (default "
                    "FLAGS_kv_cache_blocks, capped by "
                    "FLAGS_hbm_budget_bytes)")
    ap.add_argument("--rank", type=int, default=0,
                    help="this replica's rank in --fleet")
    ap.add_argument("--fleet", default=None,
                    help="comma list of ALL replica endpoints (host:port); "
                    "enables fleet membership")
    ap.add_argument("--endpoints-file", default=None,
                    help="coordinator-maintained live-endpoints file "
                    "(client failover)")
    ap.add_argument("--save-demo-model", metavar="DIR", default=None,
                    help="write a tiny fc inference model to DIR and exit")
    ap.add_argument("--save-demo-decoder", metavar="DIR", default=None,
                    help="write a tiny decoder bundle to DIR and exit")
    ap.add_argument("--role", default=None,
                    choices=("serve", "prefill", "decode"),
                    help="this replica's serving role (default: its "
                    "--roles entry, else the monolith \"serve\")")
    ap.add_argument("--roles", default=None,
                    help="comma role column parallel to --fleet "
                    "(serve|prefill|decode a slot); the coordinator puts "
                    "it in the endpoints file, so clients send __generate__ "
                    "to the prefill replicas")
    ap.add_argument("--decode-peers", default=None,
                    help="comma list of decode-role endpoints a prefill "
                    "replica streams to when no fleet role column names "
                    "any")
    ap.add_argument("--cache-dir", default=None, help="not ported")
    ap.add_argument("--speculative-k", type=int, default=None,
                    help="draft-model speculation depth for decode models "
                    "with a bundled draft (default FLAGS_speculative_k; 0 "
                    "= off)")
    ap.add_argument("--autoscale", action="store_true",
                    help="coordinator only: fork a standby replica into "
                    "the lowest dead --fleet slot on sustained queue "
                    "pressure, drain and retire the highest live rank on "
                    "sustained idle; with --roles, one controller a role "
                    "(prefill on queue depth, decode on KV-pool "
                    "occupancy), each touching its role's slots alone")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscaler floor (default "
                    "FLAGS_serving_min_replicas)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscaler ceiling (default "
                    "FLAGS_serving_max_replicas)")
    args = ap.parse_args(argv)

    for name, what in _NOT_PORTED.items():
        if getattr(args, name):
            ap.error("--%s: %s is not ported yet"
                     % (name.replace("_", "-"), what))
    if args.save_demo_model:
        print("saved demo model:", save_demo_model(args.save_demo_model))
        return 0
    if args.save_demo_decoder:
        print("saved demo decoder:",
              save_demo_decoder(args.save_demo_decoder))
        return 0
    if not args.model:
        ap.error("at least one --model NAME=DIR is required")
    if args.autoscale and not args.fleet:
        ap.error("--autoscale needs --fleet: it forks standbys into the "
                 "list's dead slots")

    import torch

    from paddle_tpu_torch.core import telemetry, tracing
    from paddle_tpu_torch.serving import (DecodeEngine, FleetMonitor,
                                          RolloutController, ServingEngine,
                                          ServingFleet, ServingServer,
                                          is_decoder_dir)

    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    # names this replica's track in a merged trace; the first record comes
    # from the main thread, so the flight recorder's SIGTERM hook is
    # installed here and chains the handler above
    tracing.set_process_name("serving-replica-%d" % args.rank)
    tracing.instant("replica_start", rank=args.rank)

    engine = ServingEngine(buckets=args.buckets, device=args.device)
    decode_engine = None
    for spec in args.model:
        name, _, dirname = spec.partition("=")
        if not dirname:
            ap.error("--model wants NAME=DIR, got %r" % spec)
        if is_decoder_dir(dirname):
            if decode_engine is None:
                decode_engine = DecodeEngine(buckets=args.decode_buckets,
                                             mode=args.decode_mode,
                                             device=args.device)
            decode_engine.add_model(name, dirname, kv_blocks=args.kv_blocks,
                                    speculative_k=args.speculative_k)
        else:
            engine.add_model(name, dirname)

    # warm before the fleet starts: a replica that joins cold can miss
    # the heartbeat timeout on its first launches and be evicted alive
    manifest = engine.prewarm()
    if decode_engine is not None:
        manifest.update(decode_engine.prewarm())
    manifest["device"] = torch.cuda.get_device_name(engine.device) \
        if engine.device.type == "cuda" else str(engine.device)
    print("PREWARM " + json.dumps(manifest), flush=True)
    # the launch counts start at 0 here, so LAUNCHES covers the served
    # traffic alone, beside the decode steps and encoder batches it ran
    for f in kernel_wrappers().values():
        f.launches = 0
    steps0 = decode_engine.steps if decode_engine is not None else 0
    batches0 = engine.batches

    if args.fleet:
        endpoints = [e.strip() for e in args.fleet.split(",") if e.strip()]
        port = args.port or int(endpoints[args.rank].rsplit(":", 1)[1])
    else:
        endpoints, port = None, args.port
    roles = None
    if args.roles:
        roles = [r.strip() for r in args.roles.split(",") if r.strip()]
        if endpoints is None or len(roles) != len(endpoints):
            ap.error("--roles must parallel --fleet")
    role = args.role or (roles[args.rank] if roles else None)
    decode_peers = [e.strip() for e in (args.decode_peers or "").split(",")
                    if e.strip()]
    server = ServingServer(engine, port=port, rank=args.rank,
                           decode_engine=decode_engine, role=role,
                           decode_peers=decode_peers).start()
    fleet = None
    if endpoints:
        fleet = ServingFleet(args.rank, endpoints, server,
                             endpoints_file=args.endpoints_file,
                             roles=roles).start()
    # serves __rollout_ctl__ and runs the canary gate; with a fleet, a
    # change is broadcast to the peers and rides the endpoints file
    server.rollout = RolloutController(server, fleet).start()
    if telemetry.enabled() and (fleet is not None or args.endpoints_file):
        server.fleetmon = FleetMonitor(
            server=server, fleet=fleet,
            endpoints_file=args.endpoints_file).start()
    server.on_retire = done.set      # a drained __retire__ exits
    scalers = []
    if args.autoscale:
        scalers = start_autoscaler(args, fleet, engine, decode_engine,
                                   server.fleetmon, roles=roles)
    print("READY port=%d pid=%d" % (server.port, os.getpid()), flush=True)
    done.wait()
    for scaler in scalers:
        scaler.stop()
    server.shutdown()                # the monitor, controller and fleet too
    print("SERVED " + json.dumps({
        "rank": args.rank,
        "decode_steps": (decode_engine.steps - steps0
                         if decode_engine is not None else 0),
        "encoder_batches": engine.batches - batches0}), flush=True)
    print("LAUNCHES " + json.dumps(kernel_launches()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
