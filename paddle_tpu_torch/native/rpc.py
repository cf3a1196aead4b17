"""Python side of the port's tensor RPC transport (``csrc/tensor_rpc.cc``).

Counterpart of ``paddle_tpu/native/rpc.py`` (``RpcServer``, ``RpcClient``,
``probe``, ``backoff_delay``), over the port's own build of the same wire
format, so a client of either package talks to a server of either: the
dtype codes (``_DTYPES``) are the reference's, in its order.

With ``FLAGS_tracing`` on, ``send_var`` stamps the active span's context
onto a SEND frame's name after ``\\x1f`` (``tracing.stamp_wire_name``), and
``poll`` records an ``rpc.recv`` instant on the sender's context for a
stamped frame (``tracing.wire_received``) and hands callers the bare name.
The client counts, under the reference's names (``core/telemetry.py``,
inert unless ``FLAGS_telemetry``), each send and its bytes
(``rpc_send_total``, ``rpc_send_bytes_total``), each get
(``rpc_get_total``), and per op each retry, failed attempt and exhausted
call (``rpc_retry_total``, ``rpc_failure_total``, ``rpc_exhausted_total``).
The fault points ``rpc.send`` and ``rpc.get``
(``utils/fault_injection.py``) map as the reference maps them: ``drop``
loses the frame before it is sent, ``error`` fails the transport after
delivery (a send's frame arrived, a get's reply is discarded); both close
the connection and raise ``FaultInjected``, a ``ConnectionError`` that
``_with_retry`` retries like a real transport failure.
"""

import ctypes
import random
import time

import numpy as np

from ..core import telemetry as _tm
from ..core import tracing as _tr
from ..utils.fault_injection import FaultInjected, maybe_fail
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
        bare, tp = _tr.strip_wire_name(name.value.decode())
        if tp is not None:
            _tr.wire_received(bare, tp)
        return t, bare, arr

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
        # SEND names reach only the server's poll, which strips the
        # context, so a stamped name never enters the var store
        wire_name = _tr.stamp_wire_name(name).encode()
        if _tm.enabled():
            _tm.inc("rpc_send_total")
            _tm.inc("rpc_send_bytes_total", int(arr.nbytes))

        def attempt():
            self._check_open(what)
            kind = maybe_fail("rpc.send")
            if kind == "drop":
                self.close()
                raise FaultInjected("%s to %s: injected frame drop"
                                    % (what, self.endpoint))
            rc = self._lib.rpcc_send_var(
                self._h, wire_name, _DT_TO_CODE[arr.dtype], dims,
                arr.ndim, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
            if rc != 0:
                raise self._err(what)
            if kind == "error":
                # delivered, then the transport fails: the retry replays a
                # frame the server already has
                self.close()
                raise FaultInjected("%s to %s: injected transport error "
                                    "after delivery" % (what, self.endpoint))

        return self._with_retry(what, attempt)

    def get_var(self, name):
        """The server's ``name``, parked server-side until it exists."""
        what = "get_var(%s)" % name
        _tm.inc("rpc_get_total")

        def attempt():
            self._check_open(what)
            kind = maybe_fail("rpc.get")
            if kind == "drop":
                self.close()
                raise FaultInjected("%s to %s: injected request drop"
                                    % (what, self.endpoint))
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
            if kind == "error":
                # the reply is lost on the way back; a GET is idempotent,
                # so the retry asks again
                self.close()
                raise FaultInjected("%s to %s: injected reply loss"
                                    % (what, self.endpoint))
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
