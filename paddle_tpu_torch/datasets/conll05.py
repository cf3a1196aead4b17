"""Synthetic CoNLL-2005 SRL (python/paddle/dataset/conll05.py interface:
test/get_dict/get_embedding).  Samples follow the reference's 9-slot
layout: (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids,
mark_ids, label_ids) with all sequences the same length."""

import numpy as np

WORD_DICT_LEN = 4000
LABEL_DICT_LEN = 59  # 29 BIO tags * 2 + O, reference label dict size
PRED_DICT_LEN = 300
EMB_DIM = 32
TEST_SIZE = 256
MIN_LEN, MAX_LEN = 5, 30


def get_dict():
    word_dict = {("w%d" % i): i for i in range(WORD_DICT_LEN)}
    verb_dict = {("v%d" % i): i for i in range(PRED_DICT_LEN)}
    label_dict = {("L%d" % i): i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = np.random.RandomState(55)
    return rng.uniform(-1, 1, (WORD_DICT_LEN, EMB_DIM)).astype("float32")


def test():
    def reader():
        rng = np.random.RandomState(56)
        for _ in range(TEST_SIZE):
            ln = int(rng.randint(MIN_LEN, MAX_LEN + 1))
            words = rng.randint(0, WORD_DICT_LEN, ln).astype("int64")
            ctx = [np.roll(words, k) for k in (2, 1, 0, -1, -2)]
            verb_pos = int(rng.randint(0, ln))
            verb = np.full(ln, int(words[verb_pos]) % PRED_DICT_LEN, "int64")
            mark = np.zeros(ln, "int64")
            mark[verb_pos] = 1
            # labels correlate with word ids so models can learn
            labels = (words + verb[0]) % LABEL_DICT_LEN
            yield tuple(list(w) for w in
                        [words] + ctx + [verb, mark, labels.astype("int64")])

    return reader


def fetch():
    pass
