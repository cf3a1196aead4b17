"""Run ``chip_smoke.py``'s phase 17 (the Fluid surface and the data path)
alone on the card: the kernels built, then ``surface_phase`` and the
verifier's summary, every failed hold collected and listed at the end
instead of stopping at the first.

    python3 tools/torch_surface_phase.py

Exits 1 if a hold failed.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAILS = []


def fail(msg):
    print("FAIL: " + msg, flush=True)
    FAILS.append(msg)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs.fail = fail
    from paddle_tpu_torch import set_f32_numerics
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    print(cs.card_line(), flush=True)
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    set_f32_numerics()
    _build.build_all()
    print("build %.1f s" % (time.perf_counter() - t0), flush=True)
    t1 = time.perf_counter()
    launches = cs.surface_phase()
    cs.verifier_summary(cs.card_line())
    print("launches", {k: v for k, v in launches.items() if v})
    print("surface phase %.1f s; total %.1f s; %s" % (
        time.perf_counter() - t1, time.perf_counter() - t0, cs.card_line()))
    print("FAILS", FAILS)
    sys.exit(1 if FAILS else 0)


if __name__ == "__main__":
    main()
