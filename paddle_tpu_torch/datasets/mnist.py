"""Synthetic MNIST (python/paddle/dataset/mnist.py interface).

Deterministic learnable digits: each class has a fixed random template;
samples are the template plus noise.  Readers yield (image[784] float32 in
[-1, 1], label int64) like the reference.
"""

import numpy as np

TRAIN_SIZE = 8192
TEST_SIZE = 1024
IMAGE_SIZE = 784
NUM_CLASSES = 10


def _templates():
    rng = np.random.RandomState(42)
    return rng.uniform(-1, 1, size=(NUM_CLASSES, IMAGE_SIZE)).astype("float32")


def _reader(n, seed):
    def reader():
        tpl = _templates()
        rng = np.random.RandomState(seed)
        labels = rng.randint(0, NUM_CLASSES, size=n)
        for i in range(n):
            y = int(labels[i])
            x = tpl[y] + 0.35 * rng.randn(IMAGE_SIZE).astype("float32")
            yield np.clip(x, -1, 1).astype("float32"), np.int64(y)

    return reader


def train():
    return _reader(TRAIN_SIZE, seed=1)


def test():
    return _reader(TEST_SIZE, seed=2)
