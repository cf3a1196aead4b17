"""The port's counter-based random stream for dropout: Philox4x32-10.

Counterpart of ``paddle_tpu/pallas_kernels/prng.py`` (``keep_threshold``,
``realized_q``, ``inv_realized_q``, the keep draw of the fused kernels)
and of the byte draw of ``paddle_tpu/ops/common.py`` (``bernoulli_bytes``).
The TPU kernels draw from the core's own generator, seeded per grid block;
the port draws from Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), keyed by an op's two seed words.

The contract, shared by every kernel (``csrc/philox.cuh`` has the same
function) and every plain version:

* **u32 stream.**  Element ``e`` of a tensor, its row-major global index,
  takes output lane ``e & 3`` of Philox4x32-10 at counter
  ``(e >> 2) & 0xffffffff, e >> 34, 0, 0`` (low word first) under the key
  ``(seed[0], seed[1])``.  The stream is a function of the element index
  alone, never of a kernel's tiling, so a backward kernel replays its
  forward's mask whatever blocks either uses.
* **Keep draw of the fused kernels** (``keep_mask``): keep iff
  ``u32 < keep_threshold(p)``, thr = round((1 - p) 2^32) clamped to >= 1;
  kept values are multiplied by ``inv_realized_q(thr)`` as float32.
* **Byte draw of the dropout op** (``keep_bytes``): the u32 stream read as
  little-endian bytes, byte ``e`` deciding element ``e`` (keep iff byte <
  round(q 256)); kept values are divided by the realized keep probability
  (``ops/common.py`` ``realized_keep_prob``).  One Philox call gives 16
  bytes.

The plain versions compute Philox in int64 tensors holding u32 values:
``mulhilo`` splits the 32-bit operand into 16-bit halves so no product
overflows a signed 64-bit integer.  They run on any device (the meta
device included, for shape inference); on the card the kernels draw the
same bits.
"""

import torch

__all__ = ["keep_threshold", "realized_q", "inv_realized_q", "seed_words",
           "words_of", "seed_tensor", "philox4x32", "random_u32",
           "random_bytes", "keep_mask", "keep_bytes"]

_TWO32 = 1 << 32
_MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def keep_threshold(dropout_prob):
    """u32 compare threshold for the keep draw; None = no dropout.
    Clamped to >= 1 so the degenerate draw cannot divide by zero."""
    q = 1.0 - float(dropout_prob)
    thr = int(round(q * _TWO32))
    if thr >= _TWO32:
        return None
    return max(thr, 1)


def realized_q(thr):
    """The keep probability the threshold actually samples with."""
    return thr / _TWO32


def inv_realized_q(thr):
    """Upscale multiplier 1/realized_q(thr)."""
    return 1.0 / realized_q(thr)


def words_of(seed):
    """The two u32 key words of an integer seed: low word, high word."""
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32


def seed_words(seed):
    """(k0, k1) python ints from a pair of ints or an int32 [2] tensor (an
    op's Seed output, which holds the words' bit patterns).  A tensor is
    read on the host: the kernels read a Seed tensor on the card
    themselves."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1).tolist()
    k0, k1 = seed
    return int(k0) & _MASK32, int(k1) & _MASK32


def seed_tensor(words, device="cpu"):
    """The int32 [2] tensor holding the bit patterns of ``words``."""
    as_i32 = [w - _TWO32 if w >= 1 << 31 else w for w in seed_words(words)]
    return torch.tensor(as_i32, dtype=torch.int32, device=device)


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of the u32 constant ``m`` times the u32
    values ``x`` (int64 tensor)."""
    a = x & 0xFFFF
    b = x >> 16
    t = a * m                        # < 2^48
    u = b * m                        # < 2^48
    s = t + ((u & 0xFFFF) << 16)     # < 2^49
    return ((s >> 32) + (u >> 16)) & _MASK32, s & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1, rounds=ROUNDS):
    """Philox4x32-``rounds`` of the counters (int64 tensors holding u32)
    under the key words ``k0``, ``k1`` (ints) -> four int64 tensors."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_u32(seed, n, device="cpu"):
    """The first ``n`` u32 values of the stream keyed by ``seed`` (int64
    tensor [n] on ``device``)."""
    k0, k1 = seed_words(seed)
    ctr = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    lanes = philox4x32(ctr & _MASK32, ctr >> 32, zero, zero, k0, k1)
    return torch.stack(lanes, dim=1).reshape(-1)[:n]


def random_bytes(seed, n, device="cpu"):
    """The first ``n`` bytes of the stream read little-endian (int64
    tensor [n] of values 0..255)."""
    words = random_u32(seed, (n + 3) // 4, device)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device)
    return ((words[:, None] >> shifts) & 0xFF).reshape(-1)[:n]


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def keep_mask(seed, thr, shape, device="cpu"):
    """Keep decisions of the fused kernels: u32 < ``thr`` (bool tensor of
    ``shape``)."""
    return (random_u32(seed, _numel(shape), device) < thr).reshape(shape)


def keep_bytes(seed, thr, shape, device="cpu"):
    """Keep decisions of the dropout op (the port's ``bernoulli_bytes``):
    byte < ``thr`` (bool tensor of ``shape``), ``thr`` in 0..256."""
    return (random_bytes(seed, _numel(shape), device) < thr).reshape(shape)
