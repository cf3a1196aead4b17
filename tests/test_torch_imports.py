"""The port stands alone: every module of ``paddle_tpu_torch`` (its own
copies of the host-only ``core/tracing.py`` and
``utils/fault_injection.py`` and the Transformer's modules among them),
``chip_smoke.py`` and the port's replica and fleet tools
(``tools/torch_serve.py``,
``tools/torch_fleet_top.py``), the recurrent nets' modules among them,
import in a process where ``jax`` and
``paddle_tpu`` cannot be imported, and the port's RPC transport is its
own library, built under ``build/native/``, never the reference
package's."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "paddle_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, ROOT)
    sys.path.insert(0, ROOT + "/tools")
    import paddle_tpu_torch
    names = ["chip_smoke", "torch_serve", "torch_fleet_top"] + sorted(
        m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch."))
    for name in names:
        importlib.import_module(name)
    for name in ("paddle_tpu_torch.core.tracing",
                 "paddle_tpu_torch.utils.fault_injection",
                 "paddle_tpu_torch.serving.disagg",
                 "paddle_tpu_torch.serving.migrate",
                 "paddle_tpu_torch.models.transformer",
                 "paddle_tpu_torch.ops.beam_search",
                 "paddle_tpu_torch.ops.control_flow",
                 "paddle_tpu_torch.ops.metrics",
                 "paddle_tpu_torch.layers.control_flow",
                 "paddle_tpu_torch.layers.learning_rate_scheduler",
                 "paddle_tpu_torch.layers.rnn",
                 "paddle_tpu_torch.layers.sequence_lod",
                 "paddle_tpu_torch.layers.extra",
                 "paddle_tpu_torch.ops.rnn",
                 "paddle_tpu_torch.ops.sequence",
                 "paddle_tpu_torch.contrib.layers",
                 "paddle_tpu_torch.contrib.layers.rnn_impl",
                 "paddle_tpu_torch.contrib.decoder",
                 "paddle_tpu_torch.contrib.decoder.beam_search_decoder",
                 "paddle_tpu_torch.models.ptb_lm"):
        assert name in sys.modules, name
    # the lazy imports run too: a span, a note, a fired fault point
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.core import tracing
    from paddle_tpu_torch.utils import fault_injection
    set_flags({"FLAGS_tracing": True, "FLAGS_telemetry": True})
    with tracing.span("s"):
        tracing.note("n")
    fault_injection.arm("p:error:1")
    assert fault_injection.maybe_fail("p") == "error"
    set_flags({"FLAGS_tracing": False, "FLAGS_telemetry": False})
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in REFUSED)
    assert not loaded, loaded
    from paddle_tpu_torch import native
    from paddle_tpu_torch.native import rpc
    srv = rpc.RpcServer(0)
    srv.shutdown()
    maps = open("/proc/self/maps").read()
    assert "_libpaddle_tpu_native" not in maps
    assert str(native.library_path()) in maps
    print("IMPORTED", len(names), native.library_path())
""")


def test_port_modules_import_without_jax_or_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", "ROOT = %r\n" % ROOT + SCRIPT],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.split()
    assert out[0] == "IMPORTED" and int(out[1]) > 60
    assert out[2].startswith(os.path.join(ROOT, "build", "native",
                                          "libtensor_rpc_"))
    for name in ("native/rpc.py", "serving/server.py", "serving/client.py",
                 "serving/codec.py", "serving/fleet.py",
                 "serving/disagg.py", "serving/migrate.py",
                 "serving/rollout.py", "serving/fleetmon.py",
                 "core/telemetry.py", "core/tracing.py",
                 "utils/fault_injection.py", "core/executor.py", "io.py",
                 "distributed/ps.py", "models/transformer.py",
                 "ops/beam_search.py", "ops/control_flow.py",
                 "layers/learning_rate_scheduler.py", "layers/rnn.py",
                 "serving/engine.py", "serving/kv_cache.py", "flags.py",
                 "ops/rnn.py", "ops/sequence.py", "models/ptb_lm.py",
                 "contrib/layers/rnn_impl.py",
                 "contrib/decoder/beam_search_decoder.py",
                 "../tools/torch_serve.py", "../tools/torch_fleet_top.py",
                 "../tools/torch_rnn_phase.py", "../chip_smoke.py"):
        with open(os.path.join(ROOT, "paddle_tpu_torch", name)) as f:
            src = f.read()
        assert "import jax" not in src and "paddle_tpu." not in src.replace(
            "paddle_tpu_torch.", "")
