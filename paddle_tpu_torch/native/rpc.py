"""Python side of the port's tensor RPC transport (``csrc/tensor_rpc.cc``).

Counterpart of ``paddle_tpu/native/rpc.py`` (``RpcServer``, ``RpcClient``,
``probe``, ``backoff_delay``), over the port's own build of the same wire
format, so a client of either package talks to a server of either: the
dtype codes (``_DTYPES``) are the reference's, in its order.

A SEND frame's name may carry a trace context after ``\\x1f`` (the
reference's ``tracing.stamp_wire_name``, when its tracing is on); ``poll``
hands callers the bare name.  The client counts, under the reference's
names (``core/telemetry.py``, inert unless ``FLAGS_telemetry``), each
send and its bytes (``rpc_send_total``, ``rpc_send_bytes_total``), each
get (``rpc_get_total``), and per op each retry, failed attempt and
exhausted call (``rpc_retry_total``, ``rpc_failure_total``,
``rpc_exhausted_total``).  Left out, compared with the reference: the
trace instants and the ``rpc.send`` / ``rpc.get`` fault points.
"""

import ctypes
import random
import time

import numpy as np

from ..core import telemetry as _tm
from . import load

__all__ = ["RpcServer", "RpcClient", "backoff_delay", "probe", "EV_SEND",
           "EV_BARRIER", "EV_COMPLETE"]

# numpy dtype <-> wire code, the reference's table in its order
_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "int8",
           "float16", "bool"]
_DT_TO_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}

EV_SEND = 1
EV_BARRIER = 3
EV_COMPLETE = 4

_WIRE_SEP = "\x1f"


def _parse_traceparent(tp):
    """``00-<32 hex trace>-<16 hex span>-<flags>`` -> (trace id, span id),
    None when malformed (the reference's ``tracing.parse_traceparent``)."""
    parts = tp.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return parts[1], parts[2]


def _strip_wire_name(name):
    """A frame name -> (bare name, traceparent or None), as the
    reference's ``tracing.strip_wire_name`` splits it."""
    if _WIRE_SEP not in name:
        return name, None
    bare, _, tp = name.partition(_WIRE_SEP)
    return bare, (tp if _parse_traceparent(tp) else None)


def probe(endpoint, key="__alive__", timeout=3.0):
    """One bounded GET of ``key``; None on any failure: a dead, hung or
    not yet listening server all read as None."""
    try:
        c = RpcClient(endpoint, connect_timeout=1.0, rpc_deadline=timeout,
                      retry_times=0)
    except ConnectionError:
        return None
    try:
        return c.get_var(key)
    except (ConnectionError, ValueError, IndexError):
        return None
    finally:
        c.close()


def backoff_delay(attempt, base=0.05, cap=2.0, rng=None):
    """Exponential backoff with equal jitter for retry ``attempt``
    (0-based): uniform in [d/2, d], d = min(cap, base * 2**attempt)."""
    d = min(float(cap), float(base) * (2.0 ** attempt))
    r = (rng or random).random()
    return d * (0.5 + 0.5 * r)


def _dims(arr):
    return (ctypes.c_longlong * max(arr.ndim, 1))(*(arr.shape or (0,)))


class RpcServer:
    """Listens on ``port`` (0: any free one, then ``self.port``) on every
    interface."""

    def __init__(self, port=0):
        self._lib = load()
        self._h = self._lib.rpcs_create(int(port))
        if not self._h:
            raise OSError("cannot bind RPC server on port %d" % port)
        self.port = self._lib.rpcs_port(self._h)

    def poll(self):
        """Block for the next inbound event -> (type, bare name, array or
        None); type 0 once the server is shut down."""
        c = ctypes
        if self._h is None:
            return 0, None, None
        name = c.create_string_buffer(1024)
        dtype = c.c_ubyte()
        dims = (c.c_longlong * 16)()
        ndim = c.c_int()
        data = c.c_void_p()
        dlen = c.c_longlong()
        t = self._lib.rpcs_poll(self._h, name, 1024, c.byref(dtype), dims, 16,
                                c.byref(ndim), c.byref(data), c.byref(dlen))
        if t == 0:
            return 0, None, None
        arr = None
        if t == EV_SEND:
            shape = tuple(dims[i] for i in range(ndim.value))
            buf = ctypes.string_at(data.value, dlen.value)
            arr = np.frombuffer(buf, dtype=np.dtype(_DTYPES[dtype.value])) \
                .reshape(shape).copy()
        return t, _strip_wire_name(name.value.decode())[0], arr

    def _check(self):
        # after shutdown the native handle is gone: a late publisher must
        # get an error, not hand the library a NULL server
        if self._h is None:
            raise ConnectionError("rpc server already shut down")

    def set_var(self, name, arr):
        self._check()
        arr = np.ascontiguousarray(arr)
        self._lib.rpcs_set_var(
            self._h, name.encode(), _DT_TO_CODE[arr.dtype], _dims(arr),
            arr.ndim, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)

    def serve(self, enable=True):
        """GETs park until this is on (and their var exists)."""
        self._check()
        self._lib.rpcs_serve(self._h, 1 if enable else 0)

    def del_var(self, name):
        self._check()
        self._lib.rpcs_del_var(self._h, name.encode())

    def bytes_moved(self):
        """(bytes read, bytes written) on every connection so far, as they
        crossed the sockets."""
        self._check()
        got, put = ctypes.c_longlong(), ctypes.c_longlong()
        self._lib.rpcs_bytes(self._h, ctypes.byref(got), ctypes.byref(put))
        return got.value, put.value

    def shutdown(self):
        if self._h:
            self._lib.rpcs_destroy(self._h)
            self._h = None


class RpcClient:
    """One connection to ``endpoint`` ("host:port"), retried until
    ``connect_timeout`` seconds pass.

    ``rpc_deadline``: seconds a request may sit idle on the socket (the
    reference's semantics: an idle timeout per syscall, not a wall-clock
    deadline; <= 0 off; the default is the reference's FLAGS_rpc_deadline
    default).  ``retry_times``: reconnect-and-retry rounds after a
    deadline or transport failure, each on a fresh connection after
    ``backoff_delay`` (the default the reference's FLAGS_rpc_retry_times).
    With 0 the first failure closes the client for good."""

    def __init__(self, endpoint, connect_timeout=60.0, rpc_deadline=180.0,
                 retry_times=3):
        self._lib = load()
        host, port = endpoint.rsplit(":", 1)
        if host in ("localhost", ""):
            host = "127.0.0.1"
        self._host, self._port = host, int(port)
        self.endpoint = endpoint
        self._h = None
        self._rng = random.Random()
        self.rpc_deadline = max(float(rpc_deadline or 0.0), 0.0)
        self.retry_times = max(int(retry_times or 0), 0)
        self._connect(connect_timeout)

    def _connect(self, connect_timeout):
        deadline = time.time() + connect_timeout
        while True:
            self._h = self._lib.rpcc_connect(self._host.encode(), self._port)
            if self._h or time.time() > deadline:
                break
            time.sleep(0.1)
        if not self._h:
            raise ConnectionError("cannot connect to %s within %.0fs"
                                  % (self.endpoint, connect_timeout))
        if self.rpc_deadline > 0:
            self._lib.rpcc_set_deadline(self._h, self.rpc_deadline)

    def _err(self, what):
        hint = (" (deadline %.0fs: server hung or connection lost)"
                % self.rpc_deadline if self.rpc_deadline > 0
                else " (connection lost)")
        # a failed socket may be mid-frame: never reuse it
        self.close()
        return ConnectionError("%s to %s failed%s"
                               % (what, self.endpoint, hint))

    def _check_open(self, what):
        if not self._h:
            raise ConnectionError(
                "%s to %s: client closed after a previous deadline or "
                "transport failure; reconnect with a new RpcClient"
                % (what, self.endpoint))

    def _with_retry(self, what, attempt_fn):
        op = what.split("(", 1)[0]
        last = None
        for i in range(self.retry_times + 1):
            if i:
                _tm.inc("rpc_retry_total", op=op)
                time.sleep(backoff_delay(i - 1, rng=self._rng))
            try:
                if not self._h:
                    if self.retry_times == 0:
                        self._check_open(what)
                    self._connect(connect_timeout=5.0)
                return attempt_fn()
            except ConnectionError as e:
                last = e
                _tm.inc("rpc_failure_total", op=op)
        _tm.inc("rpc_exhausted_total", op=op)
        raise last

    def send_var(self, name, arr):
        arr = np.ascontiguousarray(arr)
        dims = _dims(arr)
        what = "send_var(%s)" % name
        if _tm.enabled():
            _tm.inc("rpc_send_total")
            _tm.inc("rpc_send_bytes_total", int(arr.nbytes))

        def attempt():
            self._check_open(what)
            rc = self._lib.rpcc_send_var(
                self._h, name.encode(), _DT_TO_CODE[arr.dtype], dims,
                arr.ndim, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
            if rc != 0:
                raise self._err(what)

        return self._with_retry(what, attempt)

    def get_var(self, name):
        """The server's ``name``, parked server-side until it exists."""
        what = "get_var(%s)" % name
        _tm.inc("rpc_get_total")

        def attempt():
            self._check_open(what)
            c = ctypes
            dtype = c.c_ubyte()
            dims = (c.c_longlong * 16)()
            ndim = c.c_int()
            data = c.c_void_p()
            n = self._lib.rpcc_get_var(self._h, name.encode(), c.byref(dtype),
                                       dims, 16, c.byref(ndim), c.byref(data))
            if n < 0:
                raise self._err(what)
            shape = tuple(dims[i] for i in range(ndim.value))
            try:
                buf = ctypes.string_at(data.value, n)
            finally:
                self._lib.rpc_free(data)
            return np.frombuffer(buf, dtype=np.dtype(_DTYPES[dtype.value])) \
                .reshape(shape).copy()

        return self._with_retry(what, attempt)

    def barrier(self, kind):
        what = "barrier(%s)" % kind

        def attempt():
            self._check_open(what)
            if self._lib.rpcc_barrier(self._h, kind.encode()) != 0:
                raise self._err(what)

        return self._with_retry(what, attempt)

    def complete(self):
        """Fire and forget; a closed client sends nothing."""
        if self._h:
            self._lib.rpcc_complete(self._h)

    def close(self):
        if self._h:
            self._lib.rpcc_close(self._h)
            self._h = None
