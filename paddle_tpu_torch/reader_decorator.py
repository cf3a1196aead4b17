"""Reader decorators: composable sample-stream transforms.

The port's own copy of ``paddle_tpu/reader_decorator.py`` (Fluid's
python/paddle/reader/decorator.py: map_readers, shuffle, buffered,
compose, chain, firstn, xmap_readers; and paddle.batch).  A "reader" is a
nullary callable returning an iterator of samples.
"""

import itertools
import queue as _queue
import random
import threading

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "cache", "batch", "xmap_readers", "multiprocess_reader",
]


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return shuffled


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(map(make_tuple, outputs), ())

    return reader


def buffered(reader, size):
    """Prefetch up to `size` samples on a background thread."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)

        def feed():
            try:
                for d in r:
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def cache(reader):
    all_data = tuple(reader())

    def cached():
        yield from all_data

    return cached


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a sample stream with worker threads (the reference
    uses threads too — xmap_readers in python/paddle/reader/decorator.py)."""

    class _End:
        pass

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def read_worker():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(_End)

        def map_worker():
            while True:
                item = in_q.get()
                if item is _End:
                    out_q.put(_End)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=read_worker, daemon=True).start()
        workers = [threading.Thread(target=map_worker, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        if order:
            import heapq

            heap, want = [], 0
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                heapq.heappush(heap, item)
                while heap and heap[0][0] == want:
                    yield heapq.heappop(heap)[1]
                    want += 1
            while heap:
                yield heapq.heappop(heap)[1]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                yield item[1]

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """The readers chained and prefetched on a thread, as the reference
    does (the DataLoader's queue already decouples the producer from the
    card)."""
    return buffered(chain(*readers), queue_size)
