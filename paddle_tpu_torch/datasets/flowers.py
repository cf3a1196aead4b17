"""Synthetic Flowers-102 (python/paddle/dataset/flowers.py interface:
train/test/valid).  Yields (chw float32 image [3,32,32] in [0,1],
int64 label in [0,102))."""

import itertools

import numpy as np

CLASSES = 102
SHAPE = (3, 32, 32)
TRAIN_SIZE = 2048
TEST_SIZE = 512
VALID_SIZE = 512


def _reader(n, seed, cycle=False):
    def reader():
        rng0 = np.random.RandomState(77)
        tpl = rng0.uniform(0, 1, size=(CLASSES,) + SHAPE).astype("float32")
        rng = np.random.RandomState(seed)
        it = itertools.count() if cycle else range(n)
        for _ in it:
            y = int(rng.randint(0, CLASSES))
            x = tpl[y] + 0.2 * rng.randn(*SHAPE).astype("float32")
            yield np.clip(x, 0, 1).astype("float32"), np.int64(y)

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(TRAIN_SIZE, seed=21, cycle=cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader(TEST_SIZE, seed=22, cycle=cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(VALID_SIZE, seed=23)


def fetch():
    pass
