"""DataLoader / PyReader: the host-side input pipeline.

Counterpart of ``paddle_tpu/reader.py`` (``GeneratorLoader:54``,
``DataLoader.from_generator``, ``PyReader``; Fluid's reader.py and
operators/reader/buffered_reader.cc).  A producer thread pushes the
generator's batches, as numpy arrays in the feed variables' dtypes, into
the port's C++ blocking queue (``native/csrc/dataqueue.cc``).

Double buffer on the card.  Where the batches go to a CUDA device (the
iterable mode with ``places`` naming a card, or the non-iterable mode
feeding an Executor on the card), the consumer stages the NEXT batch while
the current one is in use: the arrays are copied into pinned host memory
and from there to the card with ``non_blocking=True`` on a side stream,
an event recorded after the copies.  When a staged batch is handed out,
the current stream waits on that event, and each tensor is
``record_stream``-ed on the current stream, so the caching allocator does
not hand its memory to another tensor while the step still reads it.
Elsewhere (``places`` None or the CPU) the batches are numpy arrays and
the Executor copies them.

Non-iterable mode keeps Fluid's program-driven contract: after
``loader.start()``, ``exe.run(program)`` with no feed takes the next batch
from the loader attached to the program and raises
``core.EOFException`` when the epoch ends; ``reset()`` ends the epoch.
A generator that raises surfaces in the consumer as
``RuntimeError("DataLoader generator raised")`` with the cause chained.
"""

import threading

import numpy as np
import torch

from .core import EOFException
from .core.executor import place_device
from .framework import Variable, dtype_to_np
from .reader_decorator import (  # noqa: F401  (paddle.reader.* decorators)
    batch, buffered, cache, chain, compose, firstn, map_readers,
    multiprocess_reader, shuffle, xmap_readers)

__all__ = ["DataLoader", "PyReader", "GeneratorLoader", "EOFException"]


def _to_numpy_batch(items, feed_vars):
    """One batch (a list of arrays) in the feed vars' dtypes."""
    out = []
    for i, x in enumerate(items):
        arr = np.asarray(x)
        if i < len(feed_vars) and feed_vars[i].dtype is not None:
            want = dtype_to_np(feed_vars[i].dtype)
            if arr.dtype != want:
                arr = arr.astype(want)
        out.append(arr)
    return out


def _stack(batch):
    return [np.stack([np.asarray(s[i]) for s in batch])
            for i in range(len(batch[0]))]


class _Stager:
    """Copies batches to a CUDA device on a side stream (see the module
    docstring).  ``put`` starts the copies and returns at once; ``take``
    makes the current stream wait for them."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def put(self, arrays):
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                for a in arrays]
        with torch.cuda.stream(self.stream):
            staged = [h.to(self.device, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(self.stream)
        # the pinned buffers stay referenced until the batch is taken
        return staged, done, host

    def take(self, pending):
        staged, done, _host = pending
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for t in staged:
            t.record_stream(current)
        return staged


class GeneratorLoader:
    """The loader behind ``DataLoader.from_generator`` and ``PyReader``."""

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False):
        self._feed_vars = list(feed_list or [])
        for v in self._feed_vars:
            if not isinstance(v, Variable):
                raise TypeError("feed_list must contain Variables")
        self._names = [v.name for v in self._feed_vars]
        self._capacity = capacity
        self._use_double_buffer = use_double_buffer
        self._iterable = iterable
        self._return_list = return_list
        self._batch_reader = None
        self._places = None
        self._queue = None
        self._thread = None
        self._started = False
        self._producer_exc = None
        self._iter = None  # the live epoch of next()
        # non-iterable mode: the staged next batch and its stager
        self._pending = None
        self._stager = None
        if not iterable:
            # program-driven: attach to the program that owns the feed
            # vars, where Executor.run(program, feed=None) finds it; a new
            # loader over the same feed names replaces the old one
            if not self._feed_vars:
                raise ValueError("non-iterable DataLoader needs a feed_list")
            program = self._feed_vars[0].block.program
            program._attached_loaders = [
                l for l in program._attached_loaders
                if set(l._names) != set(self._names)] + [self]

    # -- wiring ---------------------------------------------------------------
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def batch_reader():
            batch = []
            for sample in reader():
                if not isinstance(sample, (list, tuple)):
                    sample = (sample,)
                batch.append(sample)
                if len(batch) == batch_size:
                    yield _stack(batch)
                    batch = []
            if batch and not drop_last:
                yield _stack(batch)

        return self.set_batch_generator(batch_reader, places)

    def set_sample_list_generator(self, reader, places=None):
        def batch_reader():
            for batch in reader():
                yield _stack(batch)

        return self.set_batch_generator(batch_reader, places)

    def set_batch_generator(self, reader, places=None):
        self._batch_reader = reader
        self._places = places
        return self

    # -- producer -------------------------------------------------------------
    def _producer(self, queue):
        from .native.queue import QueueClosed

        try:
            for batch in self._batch_reader():
                if isinstance(batch, dict):
                    batch = [batch[n] for n in self._names]
                elif not isinstance(batch, (list, tuple)):
                    batch = (batch,)
                elif len(batch) == 1 and isinstance(batch[0], dict):
                    batch = [batch[0][n] for n in self._names]
                try:
                    queue.push(_to_numpy_batch(batch, self._feed_vars))
                except QueueClosed:
                    return
        except Exception as e:  # surfaces in the consumer
            self._producer_exc = e
        finally:
            queue.close()

    def _start_thread(self):
        from .native.queue import NativeBlockingQueue

        if self._batch_reader is None:
            raise RuntimeError(
                "DataLoader has no data source: call set_sample_generator, "
                "set_sample_list_generator or set_batch_generator first")
        self._producer_exc = None
        self._queue = NativeBlockingQueue(self._capacity)
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue,), daemon=True,
            name="DataLoader-producer")
        self._thread.start()
        self._started = True

    def _stop(self, queue=None):
        if queue is not None and queue is not self._queue:
            # an abandoned epoch's generator: kill only its own queue,
            # never the live one
            queue.kill()
            return
        if self._queue is not None:
            self._queue.kill()  # unblocks a producer stuck in push
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._queue = None
        self._thread = None
        self._started = False
        self._pending = None

    def _check_producer(self):
        if self._producer_exc is not None:
            exc, self._producer_exc = self._producer_exc, None
            raise RuntimeError("DataLoader generator raised") from exc

    @staticmethod
    def _pop(queue):
        """The next batch, or None once the epoch has ended."""
        from .native.queue import QueueClosed

        try:
            return queue.pop()
        except QueueClosed:
            return None

    # -- iterable mode --------------------------------------------------------
    def _device(self):
        """The CUDA device the iterable mode stages to, else None."""
        places = self._places
        if not self._use_double_buffer or not places:
            return None
        p = places[0] if isinstance(places, (list, tuple)) else places
        dev = place_device(p)  # raises for a card that is not there
        return dev if dev.type == "cuda" else None

    def __iter__(self):
        if not self._iterable:
            raise RuntimeError("this DataLoader is non-iterable; use "
                               "start()/reset() with exe.run()")
        self._stop()
        dev = self._device()
        self._start_thread()
        queue = self._queue
        stager = _Stager(dev) if dev is not None else None

        def gen():
            try:
                pending = None
                while True:
                    batch = self._pop(queue)
                    if batch is None:
                        self._check_producer()
                    if stager is None:
                        if batch is None:
                            return
                        yield self._emit(batch)
                        continue
                    ready = pending
                    pending = stager.put(batch) if batch is not None \
                        else None
                    if ready is not None:
                        yield self._emit(stager.take(ready))
                    elif pending is None:
                        return
            finally:
                self._stop(queue)

        return gen()

    def _emit(self, batch):
        if self._return_list:
            return list(batch)
        return dict(zip(self._names, batch))

    # -- program-driven (non-iterable) mode -----------------------------------
    def start(self):
        if self._iterable:
            raise RuntimeError("start() is only for non-iterable loaders")
        self._stop()
        self._start_thread()

    def reset(self):
        self._stop()

    def _next_feed(self, device=None):
        """The next feed dict for ``Executor.run(feed=None)`` on ``device``:
        tensors staged on the card where it is a CUDA device and the
        double buffer is on, else numpy arrays.  Raises EOFException when
        the epoch has ended."""
        if not self._started:
            raise RuntimeError("DataLoader.start() was not called")
        use_stager = self._use_double_buffer and device is not None \
            and device.type == "cuda"
        if not use_stager:
            batch = self._pop(self._queue)
            if batch is None:
                self._check_producer()
                raise EOFException("data loader drained")
            return dict(zip(self._names, batch))
        if self._stager is None or self._stager.device != device:
            self._stager = _Stager(device)
        if self._pending is None:  # the epoch's first batch
            batch = self._pop(self._queue)
            if batch is not None:
                self._pending = self._stager.put(batch)
        ready, self._pending = self._pending, None
        if ready is None:
            self._check_producer()
            raise EOFException("data loader drained")
        nxt = self._pop(self._queue)
        if nxt is not None:
            self._pending = self._stager.put(nxt)
        return dict(zip(self._names, self._stager.take(ready)))

    def next(self):
        """Successive batches of one live epoch (Fluid's ``next``)."""
        if self._iter is None:
            self._iter = iter(self)
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = None
            raise


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True):
        """A GeneratorLoader; ``use_multiprocess`` and ``drop_last`` (which
        matters across several cards) are accepted as the reference
        accepts them (the producer is a thread)."""
        return GeneratorLoader(feed_list, capacity, use_double_buffer,
                               iterable, return_list)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        raise NotImplementedError(
            "DataLoader.from_dataset waits for Dataset, which the port "
            "brings with the parameter-server work (ROADMAP A9)")


class PyReader:
    """Fluid's ``io.PyReader`` over a GeneratorLoader."""

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False):
        self._loader = GeneratorLoader(feed_list, capacity, use_double_buffer,
                                       iterable, return_list)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        self._loader.set_sample_generator(sample_generator, batch_size,
                                          drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        self._loader.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        self._loader.set_batch_generator(reader, places)

    def start(self):
        self._loader.start()

    def reset(self):
        self._loader.reset()

    def __iter__(self):
        return iter(self._loader)
