"""Synthetic PTB language-model corpus (python/paddle/dataset/imikolov.py
interface: build_dict/train/test, NGRAM and SEQ data types)."""

import numpy as np

VOCAB = 2074  # reference min_word_freq=50 dict size ballpark
TRAIN_SENTS = 2048
TEST_SENTS = 512
MIN_LEN, MAX_LEN = 4, 20


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    d = {("w%d" % i): i for i in range(VOCAB - 2)}
    d["<s>"] = VOCAB - 2
    d["<e>"] = VOCAB - 1
    return d


def _sentences(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        ln = int(rng.randint(MIN_LEN, MAX_LEN + 1))
        # markovian-ish: next word depends on previous (learnable bigrams)
        sent = [int(rng.randint(0, VOCAB - 2))]
        for _i in range(ln - 1):
            sent.append((sent[-1] * 31 + 7) % (VOCAB - 2))
        yield sent


def _reader(n, seed, word_idx, ngram_n, data_type):
    def reader():
        s_id, e_id = VOCAB - 2, VOCAB - 1
        for sent in _sentences(n, seed):
            ids = [s_id] + sent + [e_id]
            if data_type == DataType.NGRAM:
                if len(ids) >= ngram_n:
                    ids_np = np.asarray(ids, "int64")
                    for i in range(ngram_n - 1, len(ids_np)):
                        yield tuple(ids_np[i - ngram_n + 1:i + 1])
            else:
                yield np.asarray(ids[:-1], "int64"), np.asarray(
                    ids[1:], "int64")

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader(TRAIN_SENTS, 61, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader(TEST_SENTS, 62, word_idx, n, data_type)


def fetch():
    pass
