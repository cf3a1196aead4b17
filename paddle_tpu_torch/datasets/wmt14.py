"""Synthetic WMT14 en-fr (python/paddle/dataset/wmt14.py interface:
train/test/gen/get_dict).  Deterministic translation rule (id shift with a
reversal, like the wmt16 module) so seq2seq models can learn it.  Samples
are (src_ids, trg_ids_with_<s>, trg_next_ids) per the reference reader."""

import numpy as np

START_ID, END_ID, UNK_ID = 0, 1, 2
TRAIN_SIZE = 2048
TEST_SIZE = 256
MIN_LEN, MAX_LEN = 4, 16


def _dicts(dict_size):
    src = {"<s>": 0, "<e>": 1, "<unk>": 2}
    trg = dict(src)
    for i in range(3, dict_size):
        src["s%d" % i] = i
        trg["t%d" % i] = i
    return src, trg


def get_dict(dict_size, reverse=True):
    src, trg = _dicts(dict_size)
    if reverse:
        return ({v: k for k, v in src.items()},
                {v: k for k, v in trg.items()})
    return src, trg


def _translate(src_ids, dict_size):
    # target = reversed source shifted by 3 (mod usable vocab)
    usable = dict_size - 3
    return [3 + ((i - 3 + 7) % usable) for i in reversed(src_ids)]


def _reader(n, seed, dict_size):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(MIN_LEN, MAX_LEN + 1))
            src = [int(v) for v in rng.randint(3, dict_size, ln)]
            trg = _translate(src, dict_size)
            yield (src, [START_ID] + trg, trg + [END_ID])

    return reader


def train(dict_size):
    return _reader(TRAIN_SIZE, 51, dict_size)


def test(dict_size):
    return _reader(TEST_SIZE, 52, dict_size)


def gen(dict_size):
    return _reader(TEST_SIZE, 53, dict_size)


def fetch():
    pass
