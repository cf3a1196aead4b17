"""The port's data path held against the JAX package's on the CPU
(re-posing ``tests/test_reader.py``; its ``Dataset`` and ``DataFeedDesc``
cases wait for the parameter-server work).

* The C++ blocking queue: round trip of every dtype and a 0-d array,
  close-then-drain, 200 batches through two threads in order, ``kill``
  unblocking a consumer stuck in ``pop`` and a producer stuck in ``push``;
  its library is the port's own, built under ``build/native/``.
* DataLoader and PyReader in both modes: the iterable mode trains and
  batches samples; the non-iterable mode feeds ``Executor.run(feed=None)``
  to ``core.EOFException`` for two epochs, with the reference's losses
  (LOSS_ATOL) from the reference's initial weights; a producer that
  raises surfaces as ``RuntimeError("DataLoader generator raised")`` with
  the cause chained, in both modes; a loader abandoned mid-epoch and one
  ``reset()`` with its producer blocked leave no thread behind;
  ``from_dataset`` raises by name.
* The reader decorators, output for output against the reference's.
* ``datasets``: each reader of the 14 corpora yields the reference's
  samples, array for array, over its first SAMPLES samples.
* ``DataFeeder`` at lod levels 0, 1 and 2: the reference's arrays,
  dtypes and shapes exactly.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu import datasets as jds
from paddle_tpu import reader_decorator as jdec
from paddle_tpu_torch import datasets as tds
from paddle_tpu_torch import native
from paddle_tpu_torch import reader_decorator as tdec
from paddle_tpu_torch.core import scope_from_numpy
from paddle_tpu_torch.native.queue import NativeBlockingQueue, QueueClosed

LOSS_ATOL = 1e-5
SAMPLES = 32


# -- the queue ----------------------------------------------------------------


def test_queue_roundtrip_and_its_library():
    q = NativeBlockingQueue(4)
    arrays = [np.arange(12, dtype="float32").reshape(3, 4),
              np.array([[1, 2]], dtype="int64"),
              np.float32(3.5).reshape(()),
              np.arange(6, dtype="int32").reshape(2, 3).T,  # not contiguous
              np.array([True, False]), np.zeros((0, 5), "float64")]
    q.push(arrays)
    out = q.pop()
    for got, want in zip(out, arrays):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    path = str(native.library_path("dataqueue"))
    assert "/build/native/libdataqueue_" in path
    with open("/proc/self/maps") as f:
        assert path in f.read()


def test_queue_close_drains_then_raises():
    q = NativeBlockingQueue(4)
    q.push([np.zeros(2)])
    q.close()
    assert q.is_closed() and q.size() == 1
    assert q.pop() is not None
    with pytest.raises(QueueClosed):
        q.pop()
    with pytest.raises(QueueClosed):
        q.push([np.zeros(2)])
    q.reopen()
    assert q.push([np.ones(1)]) and q.pop()[0][0] == 1.0
    assert q.pop(timeout_ms=10) is None


def test_queue_blocking_between_threads():
    q = NativeBlockingQueue(2)
    n = 200

    def producer():
        for i in range(n):
            q.push([np.full((4,), i, dtype="int32")])
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    while True:
        try:
            got.append(int(q.pop()[0][0]))
        except QueueClosed:
            break
    t.join()
    assert got == list(range(n))


@pytest.mark.parametrize("side", ["pop", "push"])
def test_queue_kill_unblocks(side):
    q = NativeBlockingQueue(1)
    if side == "push":
        q.push([np.zeros(1)])  # full: the next push blocks
    errs = []

    def blocked():
        try:
            if side == "pop":
                q.pop()
            else:
                q.push([np.zeros(1)])
        except QueueClosed:
            errs.append("closed")

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.05)
    q.kill()
    t.join(timeout=5)
    assert not t.is_alive() and errs == ["closed"]


# -- the loaders --------------------------------------------------------------


def _mlp(pkg, d=8, k=3):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[d])
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        logits = pkg.layers.fc(x, k)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, x, y


def _batches(n_batches=6, bs=16, d=8, k=3, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        yield [rng.randn(bs, d).astype("float32"),
               rng.randint(0, k, (bs, 1)).astype("int64")]


def _no_producer_threads():
    deadline = time.time() + 5
    while time.time() < deadline:
        if not [t for t in threading.enumerate()
                if t.name == "DataLoader-producer"]:
            return True
        time.sleep(0.01)
    return False


def test_iterable_loader_trains():
    main, startup, loss, x, y = _mlp(tfluid)
    loader = tfluid.io.DataLoader.from_generator(
        feed_list=[x, y], capacity=8, use_double_buffer=False)
    loader.set_batch_generator(lambda: _batches(12),
                               places=tfluid.cpu_places())
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for feed in loader:
            assert isinstance(feed["x"], np.ndarray)
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0][0]))
    assert len(losses) == 12 and losses[-1] < losses[0]


@pytest.mark.parametrize("return_list", [False, True])
def test_sample_generator_batching(return_list):
    def samples():
        for i in range(25):
            yield np.full((4,), i, "float32"), np.int64(i % 3)

    out = {}
    for name, pkg in (("ref", fluid), ("port", tfluid)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[4])
            y = pkg.layers.data("y", shape=[1], dtype="int64")
        loader = pkg.io.DataLoader.from_generator(
            feed_list=[x, y], capacity=4, use_double_buffer=False,
            return_list=return_list)
        loader.set_sample_generator(samples, batch_size=10, drop_last=False)
        out[name] = list(loader)
    assert len(out["port"]) == 3
    for got, want in zip(out["port"], out["ref"]):
        if return_list:
            got, want = dict(zip("xy", got)), dict(zip("xy", want))
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].dtype == want[n].dtype
            np.testing.assert_array_equal(got[n], want[n])


def _non_iterable_losses(pkg, init=None, via_pyreader=False):
    """Two epochs of 5 batches through a non-iterable loader ->
    (losses, the initial persistables)."""
    main, startup, loss, x, y = _mlp(pkg)
    with pkg.program_guard(main, startup):
        if via_pyreader:
            loader = pkg.io.PyReader(feed_list=[x, y], capacity=4,
                                     iterable=False)
            loader.decorate_batch_generator(lambda: _batches(5))
        else:
            loader = pkg.io.DataLoader.from_generator(
                feed_list=[x, y], capacity=4, iterable=False)
            loader.set_batch_generator(lambda: _batches(5))
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    losses = []
    with pkg.scope_guard(scope):
        exe.run(startup)
        if init is None:
            init = {v.name: np.asarray(
                scope.find_var(v.name).get_tensor().numpy())
                for v in main.list_vars() if v.persistable}
        else:
            scope_from_numpy(scope, init, "cpu", program=main)
        for _epoch in range(2):
            loader.start()
            steps = 0
            try:
                while True:
                    lo, = exe.run(main, fetch_list=[loss])
                    losses.append(float(lo[0]))
                    steps += 1
            except pkg.core.EOFException:
                loader.reset()
            assert steps == 5
    return losses, init


@pytest.mark.parametrize("via_pyreader", [False, True])
def test_non_iterable_loader_matches_the_reference(via_pyreader):
    want, init = _non_iterable_losses(fluid)
    got, _ = _non_iterable_losses(tfluid, init, via_pyreader)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    assert _no_producer_threads()


def test_non_iterable_needs_start():
    main, _startup, loss, x, y = _mlp(tfluid)
    loader = tfluid.io.DataLoader.from_generator(feed_list=[x, y],
                                                 iterable=False)
    loader.set_batch_generator(lambda: _batches(1))
    with pytest.raises(RuntimeError, match="start"):
        loader._next_feed()
    with pytest.raises(RuntimeError, match="non-iterable"):
        iter(loader)
    # a second loader over the same names replaces the first
    again = tfluid.io.DataLoader.from_generator(feed_list=[x, y],
                                                iterable=False)
    assert main._attached_loaders == [again]


def _bad_batches():
    yield [np.zeros((2, 4), "float32")]
    raise ValueError("corrupt shard")


@pytest.mark.parametrize("iterable", [True, False])
def test_producer_exception_surfaces(iterable):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        y = tfluid.layers.reduce_sum(x)
    loader = tfluid.io.DataLoader.from_generator(
        feed_list=[x], capacity=2, use_double_buffer=False,
        iterable=iterable)
    loader.set_batch_generator(_bad_batches)
    if iterable:
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match="generator raised") as ei:
            for _ in it:
                pass
    else:
        exe = tfluid.Executor(tfluid.CPUPlace())
        loader.start()
        exe.run(main, fetch_list=[y])
        with pytest.raises(RuntimeError, match="generator raised") as ei:
            exe.run(main, fetch_list=[y])
        loader.reset()
    assert isinstance(ei.value.__cause__, ValueError)


def test_next_advances_and_stops():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[1])
    loader = tfluid.io.DataLoader.from_generator(
        feed_list=[x], capacity=2, use_double_buffer=False)
    loader.set_batch_generator(
        lambda: iter([[np.full((1, 1), i, "float32")] for i in range(3)]))
    assert [float(loader.next()["x"][0, 0]) for _ in range(3)] == \
        [0.0, 1.0, 2.0]
    with pytest.raises(StopIteration):
        loader.next()


def test_abandoned_and_reset_loaders_leave_no_thread():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])

    def endless():
        while True:
            yield [np.zeros((2, 4), "float32")]

    loader = tfluid.io.DataLoader.from_generator(feed_list=[x], capacity=2)
    loader.set_batch_generator(endless)
    it = iter(loader)
    next(it)
    del it  # abandoned mid-epoch; its producer is blocked in push
    assert _no_producer_threads()
    ni = tfluid.io.DataLoader.from_generator(feed_list=[x], capacity=1,
                                             iterable=False)
    ni.set_batch_generator(endless)
    ni.start()
    time.sleep(0.05)  # the producer fills the queue and blocks
    ni.reset()
    assert _no_producer_threads()


def test_from_dataset_and_a_missing_source_raise_by_name():
    with pytest.raises(NotImplementedError, match="A9"):
        tfluid.io.DataLoader.from_dataset(None)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
    with pytest.raises(RuntimeError, match="no data source"):
        iter(tfluid.io.DataLoader.from_generator(feed_list=[x]))
    with pytest.raises(TypeError):
        tfluid.io.DataLoader.from_generator(feed_list=["x"])


# -- the decorators -----------------------------------------------------------


def _r():
    return iter(range(10))


DECORATOR_CASES = {
    "firstn": lambda d: d.firstn(_r, 3),
    "map_readers": lambda d: d.map_readers(lambda a, b: a + b, _r, _r),
    "chain": lambda d: d.chain(_r, _r),
    "cache": lambda d: d.cache(_r),
    "buffered": lambda d: d.buffered(_r, 2),
    "compose": lambda d: d.compose(_r, _r),
    "batch": lambda d: d.batch(_r, 4),
    "batch_drop_last": lambda d: d.batch(_r, 4, drop_last=True),
    "xmap_ordered": lambda d: d.xmap_readers(lambda x: x * 2, _r, 3, 4,
                                             order=True),
    "multiprocess": lambda d: d.multiprocess_reader([_r, _r]),
}


@pytest.mark.parametrize("case", sorted(DECORATOR_CASES))
def test_decorators_match_the_reference(case):
    assert list(DECORATOR_CASES[case](tdec)()) == \
        list(DECORATOR_CASES[case](jdec)())


def test_unordered_decorators_keep_every_sample():
    assert sorted(tdec.shuffle(_r, 5)()) == list(range(10))
    assert sorted(tdec.xmap_readers(lambda x: x * 2, _r, 3, 4)()) == \
        [2 * i for i in range(10)]
    with pytest.raises(ValueError):
        list(tdec.compose(_r, lambda: iter(range(3)))())
    assert tfluid.batch is tdec.batch and tfluid.reader.shuffle is \
        tdec.shuffle


# -- the corpora --------------------------------------------------------------

DATASET_CASES = {
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "conll05.test": lambda d: d.conll05.test(),
    "flowers.train": lambda d: d.flowers.train(use_xmap=False),
    "imdb.train": lambda d: d.imdb.train(),
    "imikolov.ngram": lambda d: d.imikolov.train(d.imikolov.build_dict(), 5),
    "imikolov.seq": lambda d: d.imikolov.test(
        d.imikolov.build_dict(), 5, d.imikolov.DataType.SEQ),
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "movielens.train": lambda d: d.movielens.train(),
    "mq2007.pairwise": lambda d: d.mq2007.train(),
    "mq2007.listwise": lambda d: d.mq2007.test(format="listwise"),
    "sentiment.train": lambda d: d.sentiment.train(),
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "voc2012.train": lambda d: d.voc2012.train(),
    "wmt14.train": lambda d: d.wmt14.train(100),
    "wmt16.train": lambda d: d.wmt16.train(100, 100),
}


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_datasets_yield_the_reference_samples(case):
    np.random.seed(0)
    want = list(jdec.firstn(DATASET_CASES[case](jds), SAMPLES)())
    np.random.seed(0)
    got = list(tdec.firstn(DATASET_CASES[case](tds), SAMPLES)())
    assert len(got) == len(want) > 0
    _same(got, want)


def test_dataset_module_helpers_match():
    _same(tds.movielens.movie_categories(), jds.movielens.movie_categories())
    _same(tds.imdb.word_dict(), jds.imdb.word_dict())
    _same(tds.wmt14.get_dict(50), jds.wmt14.get_dict(50))
    im = np.random.RandomState(1).randint(0, 255, (40, 60, 3)).astype("uint8")
    _same(tds.image.simple_transform(im, 32, 24, False, mean=[1, 2, 3]),
          jds.image.simple_transform(im, 32, 24, False, mean=[1, 2, 3]))


# -- DataFeeder ---------------------------------------------------------------


def _feeder(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        dense = pkg.layers.data("dense", shape=[3])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        words = pkg.layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        paras = pkg.layers.data("paras", shape=[1], dtype="int64",
                                lod_level=2)
    return pkg.DataFeeder(feed_list=[dense, label, words, "paras"],
                          place=pkg.CPUPlace(), program=main)


def _samples():
    rng = np.random.RandomState(5)
    out = []
    for i in range(4):
        out.append((rng.randn(3).astype("float32"), np.int64(i % 2),
                    list(rng.randint(0, 50, rng.randint(1, 6))),
                    [list(rng.randint(0, 50, rng.randint(1, 4)))
                     for _ in range(rng.randint(1, 4))]))
    return out


def test_data_feeder_matches_the_reference_at_lod_levels_0_1_2():
    want = _feeder(fluid).feed(_samples())
    got = _feeder(tfluid).feed(_samples())
    _same(got, want)
    assert got["words"].ndim == 2 and got["paras"].ndim == 3
    chunks = [_samples()[:2], _samples()[2:]]
    _same(_feeder(tfluid).feed_parallel(chunks),
          _feeder(fluid).feed_parallel(chunks))
    with pytest.raises(ValueError, match="slots"):
        _feeder(tfluid).feed([(np.zeros(3, "float32"),)])
