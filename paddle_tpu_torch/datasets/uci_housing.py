"""Synthetic UCI housing (python/paddle/dataset/uci_housing.py interface):
linear regression data with fixed ground-truth weights.  Readers yield
(features[13] float32, price[1] float32)."""

import numpy as np

FEATURE_DIM = 13
TRAIN_SIZE = 404
TEST_SIZE = 102


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        w = np.random.RandomState(7).randn(FEATURE_DIM).astype("float32")
        for _ in range(n):
            x = rng.randn(FEATURE_DIM).astype("float32")
            y = x @ w + 0.1 * rng.randn()
            yield x, np.array([y], dtype="float32")

    return reader


def train():
    return _reader(TRAIN_SIZE, seed=3)


def test():
    return _reader(TEST_SIZE, seed=4)
