"""Sequence layers over the padded design: ``sequence_mask``.
Counterpart of ``paddle_tpu/layers/sequence_lod.py``
(``sequence_mask:168``)."""

from ..layer_helper import LayerHelper
from ..ops.common import dtype_enum

__all__ = ["sequence_mask"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] mask of j < x[...]; the op needs ``maxlen``."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": -1 if maxlen is None else int(maxlen),
                            "out_dtype": dtype_enum(dtype)})
    return out
