"""Host-side native code of the port, built with g++ and loaded with ctypes.

``csrc/tensor_rpc.cc`` (the tensor RPC transport under ``rpc.py``) is
compiled at first use into ``build/native/libtensor_rpc_<hash>.so`` at the
root of the checkout, the hash covering the source and the flags, so an
edited source rebuilds and an unchanged one is loaded as it is.  A failed
build raises; nothing falls back to a pure-Python transport.  The
reference package's own library (``paddle_tpu/native``) is never loaded.
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

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / ("libtensor_rpc_%s.so" % h.hexdigest()[:16])


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed (%d) building %s:\n%s"
                           % (proc.returncode, SOURCE, proc.stderr))
    os.replace(tmp, out)


def _declare(lib):
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


def load():
    """The transport library, built at first use.  Thread-safe."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _lib = lib
        return _lib
