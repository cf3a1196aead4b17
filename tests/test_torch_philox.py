"""The PyTorch port's dropout stream (paddle_tpu_torch/kernels/philox.py)
held against Philox4x32-10's published answers and the JAX package's
keep-probability contract, on the CPU.

* The Random123 known-answer vectors of Philox4x32-10, for the port's
  int64 tensor version and for a scalar Python Philox written here from
  the algorithm (Salmon et al., SC 2011), exactly.
* The counter/lane layout: element e is lane e & 3 of counter e >> 2
  (low word, high word), and byte e of the byte stream is byte e & 3 of
  u32 element e >> 2, little-endian; a prefix of a longer draw is the
  shorter draw.
* The thresholds and realized probabilities equal the reference's
  (``paddle_tpu.pallas_kernels.prng``, ``paddle_tpu.ops.common``) for
  several p, exactly.
* The keep fraction of both draws lies within 5 sigma of the realized
  keep probability, over 2^20 elements.
* The executor's seeds: an op draws only while its dropout is active
  (``rng_when``), and its key words are the low and high words of
  ``op_seed``, the same on every device.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import common as jcommon
from paddle_tpu.pallas_kernels import prng as jprng
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx, draws, op_seed
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.ops import common as tcommon

M32 = 0xFFFFFFFF

KNOWN = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def scalar_philox(ctr, key):
    """Philox4x32-10 on Python ints, from the algorithm."""
    c = list(ctr)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & M32]
    return tuple(c)


@pytest.mark.parametrize("ctr,key,want", KNOWN)
def test_known_answers(ctr, key, want):
    assert scalar_philox(ctr, key) == want
    got = philox.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), *key)
    assert tuple(int(t) for t in got) == want


def test_counter_and_lane_layout():
    seed = (0x12345678, 0x9abcdef0)
    n = 4 * 37 + 3
    got = philox.random_u32(seed, n).tolist()
    for e in (0, 1, 2, 3, 4, 77, n - 1):
        ctr = e >> 2
        lanes = scalar_philox((ctr & M32, ctr >> 32, 0, 0), seed)
        assert got[e] == lanes[e & 3]
    # a counter past 2^32 carries into the high word
    e = (1 << 34) + 6
    ctr = e >> 2
    want = scalar_philox((ctr & M32, ctr >> 32, 0, 0), seed)[e & 3]
    c = torch.tensor([ctr], dtype=torch.int64)
    z = torch.zeros_like(c)
    lanes = philox.philox4x32(c & M32, c >> 32, z, z, *seed)
    assert int(lanes[e & 3]) == want
    # bytes: little-endian bytes of the u32 stream
    by = philox.random_bytes(seed, 4 * n).tolist()
    for e in (0, 1, 2, 3, 5, 4 * n - 1):
        assert by[e] == (got[e >> 2] >> (8 * (e & 3))) & 0xFF
    # a draw is a prefix of any longer one: the stream ignores the shape
    assert philox.random_u32(seed, 5).tolist() == got[:5]
    mask = philox.keep_mask(seed, 1 << 31, (3, 7))
    flat = philox.keep_mask(seed, 1 << 31, (21,))
    assert torch.equal(mask.reshape(-1), flat)


def test_seed_words_round_trip():
    words = (0xDEADBEEF, 7)
    t = philox.seed_tensor(words)
    assert t.dtype == torch.int32 and t.tolist()[0] < 0
    assert philox.seed_words(t) == words
    assert philox.words_of((7 << 32) | 0xDEADBEEF) == words


@pytest.mark.parametrize("p", [0.0, 1e-12, 0.1, 0.25, 0.5, 0.9, 1.0])
def test_thresholds_equal_reference(p):
    thr = philox.keep_threshold(p)
    assert thr == jprng.keep_threshold(p)
    if thr is not None:
        assert philox.realized_q(thr) == jprng.realized_q(thr)
        assert philox.inv_realized_q(thr) == jprng.inv_realized_q(thr)
    q = 1.0 - p
    assert tcommon.realized_prob(q) == jcommon.realized_prob(q)
    assert tcommon.realized_keep_prob(q) == jcommon.realized_keep_prob(q)
    assert tcommon.byte_threshold(q) == min(max(int(round(q * 256)), 0),
                                            256)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_fraction_within_5_sigma(p):
    n = 1 << 20
    thr = philox.keep_threshold(p)
    frac = float(philox.keep_mask((3, 4), thr, (n,)).float().mean())
    q = philox.realized_q(thr)
    assert abs(frac - q) < 5 * np.sqrt(q * (1 - q) / n)
    thr8 = tcommon.byte_threshold(1 - p)
    frac = float(philox.keep_bytes((5, 6), thr8, (n,)).float().mean())
    q = tcommon.realized_prob(1 - p)
    assert abs(frac - q) < 5 * np.sqrt(q * (1 - q) / n)


def test_ops_draw_only_while_dropout_is_active():
    for op_type, on, off in (
            ("dropout", {"is_test": False}, {"is_test": True}),
            ("fused_dropout_add_ln", {"dropout_prob": 0.1, "is_test": False},
             {"dropout_prob": 0.0, "is_test": False}),
            ("flash_attention", {"dropout_prob": 0.1, "is_test": False},
             {"dropout_prob": 0.1, "is_test": True})):
        opdef = treg.get_op_def(op_type)
        assert draws(opdef, on) and not draws(opdef, off)
    assert draws(treg.get_op_def("uniform_random"), {})
    assert not draws(treg.get_op_def("mul"), {})


def test_key_words_are_the_op_seed_on_every_device():
    s = op_seed(11, 3, 17)
    assert 0 <= s < 1 << 63 and s != op_seed(11, 4, 17)
    for dev in ("cpu", "meta"):
        ctx = LowerCtx(torch.device(dev), seed=s)
        want = (0, 0) if dev == "meta" else (s & M32, s >> 32)
        assert ctx.seed_words() == want
    with pytest.raises(RuntimeError, match="no seed"):
        LowerCtx(torch.device("cpu")).seed_words()
