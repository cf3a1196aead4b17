"""Synthetic NLTK movie-reviews sentiment corpus
(python/paddle/dataset/sentiment.py interface: get_word_dict/train/test)."""

import numpy as np

VOCAB = 3000
TRAIN_SIZE = 1600
TEST_SIZE = 400
MIN_LEN, MAX_LEN = 10, 120


def get_word_dict():
    return [(("w%d" % i), i) for i in range(VOCAB)]


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        half = VOCAB // 2
        for _ in range(n):
            y = int(rng.randint(0, 2))
            ln = int(rng.randint(MIN_LEN, MAX_LEN + 1))
            lo, hi = (0, half + half // 3) if y else (half - half // 3, VOCAB)
            ids = rng.randint(lo, hi, size=ln).astype("int64")
            yield list(ids), np.int64(y)

    return reader


def train():
    return _reader(TRAIN_SIZE, 31)


def test():
    return _reader(TEST_SIZE, 32)


def fetch():
    pass
