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
    # DecodeEngine; a tiny one for smoke tests:
    python tools/torch_serve.py --save-demo-decoder /tmp/dec
    python tools/torch_serve.py --model toy=/tmp/dec --decode-buckets 4,8

    # on the CPU (the plain PyTorch path), as the tests run it
    python tools/torch_serve.py --device cpu --model fc=/path

    # an autoscaling fleet: start rank 0 alone over a list with spare
    # slots; on sustained queue pressure it forks a standby replica (this
    # command line with --rank K) into the lowest dead slot, and on
    # sustained idle it retires the highest live rank through a drain
    python tools/torch_serve.py --model fc=/path --rank 0 \
        --fleet 127.0.0.1:9000,127.0.0.1:9001 \
        --endpoints-file /tmp/eps.json --autoscale \
        --min-replicas 1 --max-replicas 2

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
    "role": "the prefill and decode roles (ROADMAP A3, serving/disagg.py)",
    "roles": "the prefill and decode roles (ROADMAP A3, serving/disagg.py)",
    "decode_peers": "the prefill and decode roles (ROADMAP A3, "
                    "serving/disagg.py)",
    "speculative_k": "speculative decode (ROADMAP A2)",
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
    """A tiny decoder bundle (the reference's demo widths and seed)."""
    from paddle_tpu_torch.serving import (DecoderConfig, init_decoder_params,
                                          save_decoder)

    cfg = DecoderConfig(vocab=vocab, layers=layers, heads=heads,
                        head_dim=head_dim, max_seq=max_seq)
    return save_decoder(dirname, cfg, init_decoder_params(cfg, seed=seed))


def is_decoder_dir(dirname):
    return os.path.exists(os.path.join(dirname, "decoder.json"))


def kernel_wrappers():
    """{kernel: wrapper} of the kernels a serving replica can reach."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ln as fl
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

    return {"paged_attention": pa.paged_attention,
            "flash_attention": fa.flash_attention,
            "fused_ln": fl.fused_ln_fwd,
            "layer_norm": ln.layer_norm_2d}


def kernel_launches():
    """{kernel: launches} of the wrappers a serving replica can reach."""
    return {k: f.launches for k, f in kernel_wrappers().items()}


def child_argv(rank, argv=None):
    """This invocation re-exec'd for fleet slot ``rank``: without
    --autoscale (a standby never scales), --rank, --min-replicas and
    --max-replicas; every other option, --device among them, kept."""
    out = [sys.executable, os.path.abspath(__file__)]
    it = iter(sys.argv[1:] if argv is None else argv)
    for a in it:
        if a == "--autoscale":
            continue
        if a in ("--rank", "--min-replicas", "--max-replicas"):
            next(it, None)
            continue
        if a.split("=", 1)[0] in ("--rank", "--min-replicas",
                                  "--max-replicas"):
            continue
        out.append(a)
    return out + ["--rank", str(rank)]


def start_autoscaler(args, fleet, engine, decode_engine, monitor):
    """The coordinator's AutoScaler over this fleet (the reference's
    role-less branch of ``tools/serve.py``): scale-up forks a standby into
    the lowest dead slot, scale-down retires the highest live rank other
    than the coordinator.  A slot whose forked standby is still starting
    counts as taken, and as a replica, so sustained pressure during its
    prewarm forks nothing more."""
    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import AutoScaler

    children = {}                   # rank -> Popen of the forked standby

    def starting():
        return {r for r, p in children.items()
                if p.poll() is None and r not in fleet.live}

    def local_depth():
        depth = len(engine._queue)
        if decode_engine is not None:
            depth += len(decode_engine._waiting)
        return depth

    def metrics():
        # the monitor's fleet-windowed view once it has a document, the
        # local queue and shed counter until then
        if monitor is not None:
            m = monitor.autoscale_metrics()
            if m is not None and m.get("replicas_up"):
                return m
        return {"queue_depth": local_depth(),
                "shed_total": telemetry.counter_total("serving_shed_total")}

    def scale_up():
        if not fleet.is_coordinator():
            return
        busy = fleet.live | starting()
        dead = [r for r in range(len(fleet.endpoints)) if r not in busy]
        if not dead:
            return
        rank = dead[0]
        fleet.notice_relaunch(rank)
        children[rank] = subprocess.Popen(child_argv(rank),
                                          start_new_session=True)

    def scale_down():
        if not fleet.is_coordinator():
            return
        cands = [r for r in sorted(fleet.live) if r != fleet.rank]
        if cands:
            fleet.retire(cands[-1])

    return AutoScaler(
        metrics, scale_up, scale_down,
        replicas_fn=lambda: len(fleet.live | starting()),
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas).start()


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
    ap.add_argument("--buckets", default="1,4,16,64",
                    help="batch buckets of the ServingEngine")
    ap.add_argument("--decode-buckets", default="4,8",
                    help="lane buckets of the DecodeEngine")
    ap.add_argument("--decode-mode", default="token",
                    choices=("token", "request", "int8"),
                    help="token-level continuous batching or the "
                    "request-level baseline (int8 KV is not ported)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV pool size in blocks")
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
    for flag in ("--role", "--roles", "--decode-peers", "--cache-dir"):
        ap.add_argument(flag, default=None, help="not ported")
    ap.add_argument("--speculative-k", type=int, default=None,
                    help="not ported")
    ap.add_argument("--autoscale", action="store_true",
                    help="coordinator only: fork a standby replica into "
                    "the lowest dead --fleet slot on sustained queue "
                    "pressure, drain and retire the highest live rank on "
                    "sustained idle")
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
    if args.decode_mode == "int8":
        ap.error("--decode-mode int8: int8 KV (ROADMAP A2) is not ported "
                 "yet")
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
                                          ServingFleet, ServingServer)

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
            decode_engine.add_model(name, dirname, kv_blocks=args.kv_blocks)
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
    server = ServingServer(engine, port=port, rank=args.rank,
                           decode_engine=decode_engine).start()
    fleet = None
    if endpoints:
        fleet = ServingFleet(args.rank, endpoints, server,
                             endpoints_file=args.endpoints_file).start()
    # serves __rollout_ctl__ and runs the canary gate; with a fleet, a
    # change is broadcast to the peers and rides the endpoints file
    server.rollout = RolloutController(server, fleet).start()
    if telemetry.enabled() and (fleet is not None or args.endpoints_file):
        server.fleetmon = FleetMonitor(
            server=server, fleet=fleet,
            endpoints_file=args.endpoints_file).start()
    server.on_retire = done.set      # a drained __retire__ exits
    scaler = None
    if args.autoscale:
        scaler = start_autoscaler(args, fleet, engine, decode_engine,
                                  server.fleetmon)
    print("READY port=%d pid=%d" % (server.port, os.getpid()), flush=True)
    done.wait()
    if scaler is not None:
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
