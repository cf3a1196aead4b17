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

Every (model, bucket) is warmed before the replica takes traffic and
before it joins a fleet; the manifest prints as one ``PREWARM {...}``
line (the device's name under "device"), then ``READY port=N``.  The
replica always runs a RolloutController behind ``__rollout_ctl__``, and a
FleetMonitor (``__fleet__`` on the coordinator) when FLAGS_telemetry is
on and a fleet or an endpoints file is given.  On SIGTERM or SIGINT, or
after a ``__retire__`` drain, it prints one ``SERVED {...}`` line (the
decode steps and encoder batches run since READY) and one ``LAUNCHES
{...}`` line (the kernel wrappers' launch counts since READY) and exits
0.  Without a card and without
``--device cpu`` it exits nonzero.
"""

import argparse
import json
import os
import signal
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
    "cache_dir": "the compile cache and --autoscale's standby forking "
                 "(ROADMAP A1b)",
    "autoscale": "--autoscale's standby forking (ROADMAP A1b)",
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
    ap.add_argument("--autoscale", action="store_true", help="not ported")
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

    import torch

    from paddle_tpu_torch.core import telemetry
    from paddle_tpu_torch.serving import (DecodeEngine, FleetMonitor,
                                          RolloutController, ServingEngine,
                                          ServingFleet, ServingServer)

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

    done = threading.Event()
    server.on_retire = done.set      # a drained __retire__ exits
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    print("READY port=%d" % server.port, flush=True)
    done.wait()
    server.shutdown()                # the monitor, controller and fleet too
    print("SERVED " + json.dumps({
        "decode_steps": (decode_engine.steps - steps0
                         if decode_engine is not None else 0),
        "encoder_batches": engine.batches - batches0}), flush=True)
    print("LAUNCHES " + json.dumps(kernel_launches()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
