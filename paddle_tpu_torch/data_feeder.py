"""DataFeeder: user samples (numpy arrays, lists) to feed dicts.

Counterpart of ``paddle_tpu/data_feeder.py`` (Fluid's data_feeder.py).  A
slot of ``lod_level`` 0 becomes one dense array of the batch; ragged
slots become padded dense batches by the reference's rule (``lod.py``):
level 1 ``[B, Tmax, ...]``, level 2 ``[B, Smax, Tmax, ...]``, zeros after
each sequence's end.
"""

import numpy as np

from .framework import Variable, default_main_program, dtype_to_np
from .lod import pad_nested_sequences, pad_sequences

__all__ = ["DataFeeder", "DataToTensorConverter"]


class DataToTensorConverter:
    """Collects one slot's values over a batch; ``done`` gives its array."""

    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = shape
        self.dtype = dtype
        self.data = []

    def feed(self, data):
        self.data.append(data)

    def done(self):
        np_dtype = dtype_to_np(self.dtype)
        if self.lod_level == 0:
            # the samples stacked as they come, as in the reference (a
            # scalar label gives [B]; the executor reads [B] for [B, 1])
            return np.array(self.data, dtype=np_dtype)
        if self.lod_level >= 2:
            out, _nseq, _lens = pad_nested_sequences(self.data, np_dtype)
            return out
        out, _lens = pad_sequences(
            [np.asarray(s, dtype=np_dtype) for s in self.data], np_dtype)
        return out


class DataFeeder:
    """``feed(samples)`` -> {name: array} for the variables of
    ``feed_list`` (Variables or their names in ``program``)."""

    def __init__(self, feed_list, place, program=None):
        self.place = place
        program = program or default_main_program()
        self.feed_names = []
        self.feed_shapes = []
        self.feed_dtypes = []
        self.feed_lod_level = []
        for each in feed_list:
            if isinstance(each, str):
                each = program.global_block().var(each)
            if not isinstance(each, Variable):
                raise TypeError("feed_list items must be Variable or str")
            self.feed_names.append(each.name)
            self.feed_shapes.append(each.shape)
            self.feed_dtypes.append(each.dtype)
            self.feed_lod_level.append(each.lod_level)

    def feed(self, iterable):
        converters = [
            DataToTensorConverter(self.place, lod, shape, dtype)
            for lod, shape, dtype in zip(self.feed_lod_level,
                                         self.feed_shapes, self.feed_dtypes)]
        for each_sample in iterable:
            if len(each_sample) != len(converters):
                raise ValueError("sample has %d slots, feeder expects %d"
                                 % (len(each_sample), len(converters)))
            for value, conv in zip(each_sample, converters):
                conv.feed(value)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}

    def feed_parallel(self, iterable, num_places=None):
        """One feed dict per chunk of samples."""
        return [self.feed(chunk) for chunk in iterable]
