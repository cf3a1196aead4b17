"""Input declaration: ``data``.  Counterpart of
``paddle_tpu/layers/tensor.py`` (``data:43``)."""

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=None, stop_gradient=True):
    """Declare an input variable; with ``append_batch_size`` a leading -1
    batch dim is added."""
    helper = LayerHelper("data")  # consumes a name, as the reference does
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.program.global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        is_data=True, need_check_feed=True, stop_gradient=stop_gradient)
