"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/kernels/lib<name>_<hash>.so`` at the root of the checkout, at
first use.  The hash covers the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source rebuilds and an unchanged one is loaded
as it is.  Sources include no
PyTorch header, which keeps a build to seconds (a source that includes
PyTorch's headers takes minutes).  A failed build raises; nothing falls
back to the plain PyTorch versions."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "function", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "fused_ln", "fused_ln_bwd", "layer_norm", "fused_adam",
           "dropout", "small_attention", "small_attention_bwd",
           "conv_block", "fused_momentum", "embedding_bag",
           "channel_stats")

_lock = threading.Lock()
_libs = {}
_fns = {}
# name -> {"seconds": float, "cached": bool, "ptxas": str}, for reports
BUILD_INFO = {}


def nvcc_path():
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``;
    raises when none exists."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built on a machine with the CUDA toolkit")


def _target(name):
    src = CSRC / (name + ".cu")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return src, BUILD_DIR / ("lib%s_%s.so" % (name, h.hexdigest()[:16]))


def _start(name):
    """Start one nvcc for ``name`` -> (Popen or None if cached, src, out,
    tmp, t0)."""
    src, out = _target(name)
    if out.exists():
        return None, src, out, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, src, out, tmp, time.perf_counter()


def _finish(name, started):
    proc, src, out, tmp, t0 = started
    if proc is None:
        BUILD_INFO[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (%d) building %s:\n%s"
                           % (proc.returncode, src, log))
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "cached": False, "ptxas": log}
    return out


def build_all(names=SOURCES):
    """Build every named source at once (one nvcc each, all started
    together) and load them.  Returns {name: ctypes.CDLL}."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = {}
        try:
            for n in todo:
                started[n] = _start(n)
            for n in todo:
                _libs[n] = ctypes.CDLL(str(_finish(n, started[n])))
        finally:
            # a failed build leaves no compiler running behind it
            for proc, *_rest in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return {n: _libs[n] for n in names}


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    return lib


def function(name, symbol, argtypes):
    """``symbol`` of ``csrc/<name>.cu`` as a ctypes function that returns
    the launch's cudaError_t, built and typed once: the kernel wrappers
    call it on every launch."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name, symbol] = fn
    return fn
