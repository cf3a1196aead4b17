"""Synthetic WMT16 (python/paddle/dataset/wmt16.py interface): a
deterministic "translation" corpus where the target is a learnable
transformation of the source (token shift + reversal), exercising the full
variable-length seq2seq path.  Readers yield (src_ids, trg_ids, trg_next)
with <s>=0, <e>=1, <unk>=2 like the reference."""

import numpy as np

BOS, EOS, UNK = 0, 1, 2
RESERVED = 3


def _reader(n, seed, src_vocab_size, trg_vocab_size, min_len=4, max_len=16):
    def reader():
        rng = np.random.RandomState(seed)
        usable = min(src_vocab_size, trg_vocab_size) - RESERVED
        for _ in range(n):
            ln = int(rng.randint(min_len, max_len + 1))
            src = rng.randint(0, usable, size=ln)
            # target: reversed source with a +1 shift (mod usable vocab)
            trg = (src[::-1] + 1) % usable
            src_ids = (src + RESERVED).astype("int64").tolist()
            trg_full = [BOS] + (trg + RESERVED).astype("int64").tolist() + [EOS]
            yield src_ids, trg_full[:-1], trg_full[1:]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en", min_len=4, max_len=16):
    return _reader(4096, 11, src_dict_size, trg_dict_size, min_len, max_len)


def test(src_dict_size, trg_dict_size, src_lang="en", min_len=4, max_len=16):
    return _reader(512, 12, src_dict_size, trg_dict_size, min_len, max_len)


def validation(src_dict_size, trg_dict_size, src_lang="en", min_len=4,
               max_len=16):
    return _reader(512, 13, src_dict_size, trg_dict_size, min_len, max_len)
