"""Multi-level LoD <-> padded-dense conversion.

The port's own copy of ``paddle_tpu/lod.py``.  Fluid represents nested
variable-length structure as LoD offsets (framework/lod_tensor.h:52,
``LoD = vector<Vector<size_t>>``, e.g. paragraphs -> sentences -> words on
one flat buffer); both packages run padded dense tensors with per-level
length arrays instead, and this module is the bridge:

  level 1: list[seq]                 -> [B, T, ...]        + len [B]
  level 2: list[list[seq]]           -> [B, S, T, ...]     + (nseq [B],
                                                             len [B, S])

``lengths_to_lod`` / ``lod_to_lengths`` convert between the offset form and
per-level length lists.
"""

import numpy as np

__all__ = [
    "pad_sequences", "pad_nested_sequences", "unpad_nested_sequences",
    "lengths_to_lod", "lod_to_lengths",
]


def lengths_to_lod(lengths_per_level):
    """[[2,1],[3,2,4]] -> [[0,2,3],[0,3,5,9]] (offset form, lod_tensor.h)."""
    lod = []
    for lens in lengths_per_level:
        offs = [0]
        for l in lens:
            offs.append(offs[-1] + int(l))
        lod.append(offs)
    return lod


def lod_to_lengths(lod):
    return [[b - a for a, b in zip(l, l[1:])] for l in lod]


def pad_sequences(seqs, dtype=None):
    """level-1: list of [Ti, ...] -> ([B, Tmax, ...], lengths [B])."""
    seqs = [np.asarray(s) for s in seqs]
    dtype = dtype or seqs[0].dtype
    tmax = max((s.shape[0] for s in seqs), default=0)
    tail = seqs[0].shape[1:] if seqs else ()
    out = np.zeros((len(seqs), tmax) + tail, dtype)
    lens = np.zeros((len(seqs),), "int64")
    for i, s in enumerate(seqs):
        out[i, : s.shape[0]] = s
        lens[i] = s.shape[0]
    return out, lens


def pad_nested_sequences(nested, dtype=None):
    """level-2: list (batch) of lists (seqs) of [Ti, ...] arrays ->
    ([B, Smax, Tmax, ...], nseq [B], lens [B, Smax])."""
    B = len(nested)
    flat0 = next((np.asarray(s) for row in nested for s in row), None)
    if flat0 is None:
        raise ValueError("empty nested batch")
    dtype = dtype or flat0.dtype
    smax = max(len(row) for row in nested)
    tmax = max((np.asarray(s).shape[0] for row in nested for s in row),
               default=0)
    tail = flat0.shape[1:]
    out = np.zeros((B, smax, tmax) + tail, dtype)
    nseq = np.zeros((B,), "int64")
    lens = np.zeros((B, smax), "int64")
    for i, row in enumerate(nested):
        nseq[i] = len(row)
        for j, s in enumerate(row):
            s = np.asarray(s)
            out[i, j, : s.shape[0]] = s
            lens[i, j] = s.shape[0]
    return out, nseq, lens


def unpad_nested_sequences(arr, nseq, lens):
    """Inverse of pad_nested_sequences."""
    out = []
    for i in range(arr.shape[0]):
        row = []
        for j in range(int(nseq[i])):
            row.append(np.asarray(arr[i, j, : int(lens[i, j])]))
        out.append(row)
    return out
