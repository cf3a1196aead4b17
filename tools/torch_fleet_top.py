"""Live top-style dashboard over a serving fleet's metrics plane, on the
PyTorch port (``paddle_tpu_torch.serving.fleetmon``); it reads fleets of
either package's replicas.

Usage:
    # aggregate locally: re-read the endpoints file each refresh, scrape
    # every live replica, merge (serving/fleetmon.py FleetMonitor)
    python tools/torch_fleet_top.py --endpoints-file /tmp/eps.json

    # static endpoint list (no fleet file, e.g. a test rig)
    python tools/torch_fleet_top.py --endpoints 127.0.0.1:9000,127.0.0.1:9001

    # read the coordinator's already-merged __fleet__ doc (one GET
    # instead of N scrapes; needs a running FleetMonitor over there)
    python tools/torch_fleet_top.py --scrape 127.0.0.1:9000

    # scripting: one sample, machine-readable
    python tools/torch_fleet_top.py --endpoints 127.0.0.1:9000 --once --json

Each refresh shows one row per replica (role, queue depth, batch fill,
KV occupancy, prefix hit rate, per-phase p99s) over fleet-level lines:
goodput vs raw throughput, windowed shed/token rates, and every SLO
rule's multi-window burn rate with its FIRING/ok state.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_monitor = [None]                      # kept across refreshes: the ring


def collect(args):
    """One fleet doc: either the coordinator's published ``__fleet__``
    aggregate, or a local FleetMonitor tick (the monitor persists
    between refreshes so windowed rates/percentiles have history)."""
    if args.endpoint:
        from paddle_tpu_torch.core import telemetry
        from paddle_tpu_torch.serving.fleetmon import FLEET_RPC_KEY

        return telemetry.scrape(args.endpoint, timeout=args.timeout,
                                key=FLEET_RPC_KEY)
    if _monitor[0] is None:
        from paddle_tpu_torch.serving.fleetmon import FleetMonitor

        eps = [e.strip() for e in (args.endpoints or "").split(",")
               if e.strip()] or None
        _monitor[0] = FleetMonitor(endpoints_file=args.endpoints_file,
                                   endpoints=eps)
    return _monitor[0].tick()


def render(doc, out=sys.stdout, clear=False):
    if clear:
        out.write("\x1b[2J\x1b[H")
    out.write("fleet_top  t=%.1f  epoch=%s  replicas up=%s  "
              "(refresh data: %gs rate window)\n"
              % (doc.get("t", 0.0), doc.get("epoch", "?"),
                 doc.get("replicas_up", "?"),
                 doc.get("rate_window_s", 0.0)))
    out.write("%-22s %-8s %-3s %5s %5s %5s %5s %9s %9s %9s\n"
              % ("ENDPOINT", "ROLE", "UP", "QD", "FILL", "KV%", "HIT%",
                 "SRV p99", "TTFT p99", "ITL p99"))
    for r in doc.get("replicas", []):
        p99 = r.get("p99_ms", {})
        out.write("%-22s %-8s %-3s %5g %5.2f %5.1f %5.1f %9g %9g %9g\n"
                  % (r.get("endpoint", "?"), r.get("role", "?"),
                     "y" if r.get("up") else "N",
                     r.get("queue_depth", 0.0),
                     r.get("batch_fill_p50", 0.0),
                     100.0 * r.get("kv_occupancy", 0.0),
                     100.0 * r.get("prefix_hit_rate", 0.0),
                     p99.get("server_ms", 0.0),
                     p99.get("ttft_ms", 0.0),
                     p99.get("itl_ms", 0.0)))
    gp = doc.get("goodput", {})
    if gp:
        out.write("goodput  %.1f/%.1f replies/s met deadline   "
                  "%.1f/%.1f tokens/s   missed %.2f/s\n"
                  % (gp.get("replies_per_s", 0.0),
                     gp.get("raw_replies_per_s", 0.0),
                     gp.get("tokens_per_s", 0.0),
                     gp.get("raw_tokens_per_s", 0.0),
                     gp.get("missed_per_s", 0.0)))
    rates = doc.get("rates", {})
    shed = sum(v for k, v in rates.items()
               if k.split("{", 1)[0] == "serving_shed_total")
    if shed:
        out.write("shedding %.2f/s\n" % shed)
    for s in doc.get("slo", []):
        out.write("slo %-14s p%d(%s) %gms/%gms obj  burn fast=%.2f "
                  "slow=%.2f  [%s]\n"
                  % (s["name"], round(s["quantile"] * 100), s["metric"],
                     s["p_fast_ms"], s["objective_ms"], s["burn_fast"],
                     s["burn_slow"],
                     "FIRING" if s["active"] else "ok"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--endpoints-file",
                     help="fleet endpoints file (re-read each refresh; "
                     "membership changes appear live)")
    src.add_argument("--endpoints",
                     help="comma list of replica endpoints (static rig)")
    src.add_argument("--scrape", dest="endpoint",
                     help="coordinator HOST:PORT — GET the published "
                     "__fleet__ aggregate instead of scraping N replicas")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (live mode)")
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="per-scrape RPC deadline in seconds")
    ap.add_argument("--once", action="store_true",
                    help="one sample then exit (no screen clearing)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw fleet doc as JSON (scripting)")
    args = ap.parse_args(argv)

    while True:
        doc = collect(args)
        if args.as_json:
            json.dump(doc, sys.stdout, indent=1)
            sys.stdout.write("\n")
        else:
            render(doc, clear=not args.once)
        sys.stdout.flush()
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
