"""Bounded blocking queue of ndarray batches over ``csrc/dataqueue.cc``.

Counterpart of ``paddle_tpu/native/queue.py`` (``NativeBlockingQueue:59``):
a batch crosses the producer/consumer boundary as one contiguous byte
buffer (a count, then per array its dtype string, rank, shape and bytes),
in the reference's layout.
"""

import ctypes
import struct

import numpy as np

from . import load

__all__ = ["NativeBlockingQueue", "QueueClosed"]


class QueueClosed(Exception):
    """The queue was closed and drained, or killed."""


def _pack(arrays):
    parts = [struct.pack("<i", len(arrays))]
    for a in arrays:
        a = np.asarray(a)
        if not a.flags["C_CONTIGUOUS"]:
            a = np.ascontiguousarray(a)  # (a 0-d array always is)
        dt = a.dtype.str.encode()  # e.g. b"<f4"
        parts += [struct.pack("<i", len(dt)), dt,
                  struct.pack("<i", a.ndim),
                  struct.pack("<%dq" % a.ndim, *a.shape), a.tobytes()]
    return b"".join(parts)


def _unpack(buf):
    off = 0
    (n,) = struct.unpack_from("<i", buf, off)
    off += 4
    out = []
    for _ in range(n):
        (dtlen,) = struct.unpack_from("<i", buf, off)
        off += 4
        dt = np.dtype(buf[off:off + dtlen].decode())
        off += dtlen
        (ndim,) = struct.unpack_from("<i", buf, off)
        off += 4
        shape = struct.unpack_from("<%dq" % ndim, buf, off)
        off += 8 * ndim
        count = int(np.prod(shape)) if ndim else 1
        out.append(np.frombuffer(buf, dtype=dt, count=count,
                                 offset=off).reshape(shape))
        off += count * dt.itemsize
    return out


class NativeBlockingQueue:
    """Bounded blocking queue of ndarray batches, held in C++.  ``push``
    and ``pop`` block (``timeout_ms`` < 0) or wait at most ``timeout_ms``;
    ``close`` lets the consumer drain what is left, ``kill`` drops it and
    wakes every waiter at once."""

    def __init__(self, capacity=64):
        self._lib = load("dataqueue")
        self._q = self._lib.dq_create(int(capacity))

    def push(self, arrays, timeout_ms=-1):
        """True once queued, False on a timeout; QueueClosed if closed."""
        buf = _pack(arrays)
        rc = self._lib.dq_push(self._q, buf, len(buf), timeout_ms)
        if rc == -1:
            raise QueueClosed()
        return rc == 0

    def pop(self, timeout_ms=-1):
        """The next batch (a list of arrays), None on a timeout;
        QueueClosed once closed and drained, or killed."""
        out = ctypes.c_void_p()
        n = self._lib.dq_pop(self._q, ctypes.byref(out), timeout_ms)
        if n == -1:
            raise QueueClosed()
        if n == -2:
            return None
        try:
            buf = ctypes.string_at(out, n)
        finally:
            self._lib.dq_free(out)
        return _unpack(buf)

    def close(self):
        self._lib.dq_close(self._q)

    def kill(self):
        self._lib.dq_kill(self._q)

    def reopen(self):
        self._lib.dq_reopen(self._q)

    def size(self):
        return self._lib.dq_size(self._q)

    def is_closed(self):
        return bool(self._lib.dq_is_closed(self._q))

    def __del__(self):
        q, self._q = getattr(self, "_q", None), None
        if q:
            self._lib.dq_kill(q)
            self._lib.dq_destroy(q)
