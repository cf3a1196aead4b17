"""LoDTensor and its construction helpers.

Counterpart of ``paddle_tpu/lod_tensor.py`` (``create_lod_tensor``,
``create_random_int_lodtensor``; Fluid's lod_tensor.py:24, :114).  A
``LoDTensor`` holds the flat [total, ...] data, as Fluid's does, with the
recursive sequence lengths as its LoD; the sequence ops read padded views
built by ``lod.py``.
"""

import numpy as np

from .core.scope import Tensor
from .lod import lengths_to_lod, lod_to_lengths

__all__ = ["LoDTensor", "create_lod_tensor", "create_random_int_lodtensor"]


class LoDTensor(Tensor):
    """A scope tensor with LoD metadata (Fluid's ``core.LoDTensor``)."""

    __slots__ = ("_lod",)

    def __init__(self, value=None):
        super().__init__(value)
        self._lod = []

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def set_lod(self, lod):
        self._lod = [list(level) for level in lod]

    def lod(self):
        return self._lod

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = lengths_to_lod(lengths)

    def recursive_sequence_lengths(self):
        return lod_to_lengths(self._lod)

    def shape(self):
        return list(np.shape(self.numpy())) if self._is_initialized() \
            else []


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """A LoDTensor of ``data`` (a LoDTensor, a list of scalar sequences or
    an array of the rows) with ``recursive_seq_lens``; raises ValueError
    where the lengths do not describe the data."""
    if isinstance(data, Tensor):
        t = LoDTensor(np.asarray(data.numpy()))
        t.set_recursive_sequence_lengths(recursive_seq_lens)
        return t
    if isinstance(data, list):
        # a ragged list of scalar sequences becomes [total, 1], and the
        # caller's lengths must be the list's
        new_lens = [len(seq) for seq in data]
        if (len(recursive_seq_lens) != 1
                or list(recursive_seq_lens[0]) != new_lens):
            raise ValueError(
                "recursive_seq_lens %s does not match the list structure "
                "(lengths %s)" % (recursive_seq_lens, new_lens))
        flat = []
        for seq in data:
            for v in seq:
                if isinstance(v, (list, tuple)):
                    raise ValueError(
                        "list data must hold scalar sequences; pass a "
                        "numpy array for multi-dim rows")
                flat.append(v)
        t = LoDTensor(np.asarray(flat).reshape(-1, 1))
        t.set_recursive_sequence_lengths([new_lens])
        return t
    arr = np.asarray(data)
    total = sum(recursive_seq_lens[-1])
    if arr.shape[0] != total:
        raise ValueError(
            "data rows (%d) must equal the sum of the last-level lengths "
            "(%d)" % (arr.shape[0], total))
    t = LoDTensor(arr)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """Ints drawn from numpy's global generator in [low, high], int64."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             [total] + list(base_shape)).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
