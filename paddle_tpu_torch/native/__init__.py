"""Host-side native code of the port, built with g++ and loaded with ctypes.

Each library is built from its own source in ``csrc/`` at first use, into
``build/native/lib<name>_<hash>.so`` at the root of the checkout, the hash
covering that source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is:

- ``tensor_rpc`` (``csrc/tensor_rpc.cc``): the tensor RPC transport under
  ``rpc.py``;
- ``dataqueue`` (``csrc/dataqueue.cc``): the bounded blocking queue of
  batches under ``queue.py``, the DataLoader's producer/consumer hand-off.

A failed build raises; nothing falls back to a pure-Python transport or
queue.  The reference package's own library (``paddle_tpu/native``) is
never loaded.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
SOURCE = CSRC / "tensor_rpc.cc"
QUEUE_SOURCE = CSRC / "dataqueue.cc"

_lock = threading.Lock()
_libs = {}


def _source(name):
    return {"tensor_rpc": SOURCE, "dataqueue": QUEUE_SOURCE}[name]


def library_path(name="tensor_rpc"):
    """Where library ``name`` for its current source and flags lives."""
    h = hashlib.sha256(_source(name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / ("lib%s_%s.so" % (name, h.hexdigest()[:16]))


def _build(out, name="tensor_rpc"):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    src = _source(name)
    proc = subprocess.run(["g++", *FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed (%d) building %s:\n%s"
                           % (proc.returncode, src, proc.stderr))
    os.replace(tmp, out)


def _declare_rpc(lib):
    c = ctypes
    lib.rpcs_create.restype = c.c_void_p
    lib.rpcs_create.argtypes = [c.c_int]
    lib.rpcs_port.restype = c.c_int
    lib.rpcs_port.argtypes = [c.c_void_p]
    lib.rpcs_poll.restype = c.c_int
    lib.rpcs_poll.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int, c.POINTER(c.c_ubyte),
        c.POINTER(c.c_longlong), c.c_int, c.POINTER(c.c_int),
        c.POINTER(c.c_void_p), c.POINTER(c.c_longlong),
    ]
    lib.rpcs_set_var.restype = None
    lib.rpcs_set_var.argtypes = [
        c.c_void_p, c.c_char_p, c.c_ubyte, c.POINTER(c.c_longlong),
        c.c_int, c.c_void_p, c.c_longlong,
    ]
    lib.rpcs_serve.restype = None
    lib.rpcs_serve.argtypes = [c.c_void_p, c.c_int]
    lib.rpcs_del_var.restype = None
    lib.rpcs_del_var.argtypes = [c.c_void_p, c.c_char_p]
    lib.rpcs_bytes.restype = None
    lib.rpcs_bytes.argtypes = [c.c_void_p, c.POINTER(c.c_longlong),
                               c.POINTER(c.c_longlong)]
    lib.rpcs_destroy.restype = None
    lib.rpcs_destroy.argtypes = [c.c_void_p]
    lib.rpcc_connect.restype = c.c_void_p
    lib.rpcc_connect.argtypes = [c.c_char_p, c.c_int]
    lib.rpcc_set_deadline.restype = None
    lib.rpcc_set_deadline.argtypes = [c.c_void_p, c.c_double]
    lib.rpcc_send_var.restype = c.c_int
    lib.rpcc_send_var.argtypes = [
        c.c_void_p, c.c_char_p, c.c_ubyte, c.POINTER(c.c_longlong),
        c.c_int, c.c_void_p, c.c_longlong,
    ]
    lib.rpcc_get_var.restype = c.c_longlong
    lib.rpcc_get_var.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_ubyte),
        c.POINTER(c.c_longlong), c.c_int, c.POINTER(c.c_int),
        c.POINTER(c.c_void_p),
    ]
    lib.rpcc_barrier.restype = c.c_int
    lib.rpcc_barrier.argtypes = [c.c_void_p, c.c_char_p]
    lib.rpcc_complete.restype = c.c_int
    lib.rpcc_complete.argtypes = [c.c_void_p]
    lib.rpcc_close.restype = None
    lib.rpcc_close.argtypes = [c.c_void_p]
    lib.rpc_free.restype = None
    lib.rpc_free.argtypes = [c.c_void_p]


def _declare_queue(lib):
    c = ctypes
    lib.dq_create.restype = c.c_void_p
    lib.dq_create.argtypes = [c.c_int]
    lib.dq_destroy.restype = None
    lib.dq_destroy.argtypes = [c.c_void_p]
    lib.dq_push.restype = c.c_int
    lib.dq_push.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.c_int]
    lib.dq_pop.restype = c.c_int64
    lib.dq_pop.argtypes = [c.c_void_p, c.POINTER(c.c_void_p), c.c_int]
    lib.dq_free.restype = None
    lib.dq_free.argtypes = [c.c_void_p]
    for fn in ("dq_close", "dq_kill", "dq_reopen"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.dq_size.restype = c.c_int
    lib.dq_size.argtypes = [c.c_void_p]
    lib.dq_is_closed.restype = c.c_int
    lib.dq_is_closed.argtypes = [c.c_void_p]


_DECLARE = {"tensor_rpc": _declare_rpc, "dataqueue": _declare_queue}


def load(name="tensor_rpc"):
    """Library ``name``, built at first use.  Thread-safe."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = library_path(name)
            if not out.exists():
                _build(out, name)
            lib = ctypes.CDLL(str(out))
            _DECLARE[name](lib)
            _libs[name] = lib
        return lib
