"""Synthetic CIFAR (python/paddle/dataset/cifar.py interface: train10/
test10/train100/test100).  Class-templated 3x32x32 images, flattened
float32 in [0,1] + int64 label, like the reference readers."""

import itertools

import numpy as np

DIM = 3 * 32 * 32
TRAIN_SIZE = 4096
TEST_SIZE = 1024


def _templates(num_classes):
    rng = np.random.RandomState(100 + num_classes)
    return rng.uniform(0, 1, size=(num_classes, DIM)).astype("float32")


def _reader(n, num_classes, seed, cycle=False):
    def reader():
        tpl = _templates(num_classes)
        it = itertools.count() if cycle else range(n)
        rng = np.random.RandomState(seed)
        for _ in it:
            y = int(rng.randint(0, num_classes))
            x = tpl[y] + 0.25 * rng.randn(DIM).astype("float32")
            yield np.clip(x, 0, 1).astype("float32"), np.int64(y)

    return reader


def train100():
    return _reader(TRAIN_SIZE, 100, seed=11)


def test100():
    return _reader(TEST_SIZE, 100, seed=12)


def train10(cycle=False):
    return _reader(TRAIN_SIZE, 10, seed=13, cycle=cycle)


def test10(cycle=False):
    return _reader(TEST_SIZE, 10, seed=14, cycle=cycle)


def fetch():
    pass
