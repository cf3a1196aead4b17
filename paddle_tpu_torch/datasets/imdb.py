"""Synthetic IMDB sentiment (python/paddle/dataset/imdb.py interface):
variable-length token-id sequences whose class-conditional token
distributions differ, so bag-of-words/rnn models can learn.  Readers yield
(word_ids list[int64], label int64 in {0,1})."""

import numpy as np

VOCAB_SIZE = 5149  # reference imdb word_dict size ballpark
TRAIN_SIZE = 2048
TEST_SIZE = 512
MIN_LEN, MAX_LEN = 8, 100


def word_dict():
    return {("w%d" % i).encode(): i for i in range(VOCAB_SIZE)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        half = VOCAB_SIZE // 2
        for _ in range(n):
            y = int(rng.randint(0, 2))
            ln = int(rng.randint(MIN_LEN, MAX_LEN + 1))
            # positive reviews skew to the lower half of the vocab
            lo, hi = (0, half + half // 2) if y else (half - half // 2, VOCAB_SIZE)
            ids = rng.randint(lo, hi, size=ln).astype("int64")
            yield list(ids), np.int64(y)

    return reader


def train(word_idx=None):
    return _reader(TRAIN_SIZE, seed=5)


def test(word_idx=None):
    return _reader(TEST_SIZE, seed=6)
