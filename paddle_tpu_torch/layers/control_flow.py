"""Comparison layers, ``logical_and``, ``increment`` and the tensor-array
layers, which the reference keeps in its control-flow module.  Counterpart of
``paddle_tpu/layers/control_flow.py`` (``increment:74``,
``create_array:87``, ``array_write:95``, ``_make_compare:145``).  The
reference's loops (``While``, ``cond``) wait for the port's control
flow: building with them raises."""

from ..layer_helper import LayerHelper
from ..utils import unique_name

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "logical_and", "increment", "create_array",
           "array_write", "While", "cond"]


def increment(x, value=1.0, in_place=True):
    """x + value, written into x itself unless ``in_place`` is False."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def create_array(dtype):
    """An empty tensor array of ``dtype``; its first write makes it."""
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name=unique_name.generate("array"), dtype=dtype, shape=None,
        type="LOD_TENSOR_ARRAY")


def array_write(x, i, array=None):
    """``array`` with x at index i (a [1] int tensor)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]})
    return array


def _not_ported(op_type):
    def layer(*args, **kwargs):
        raise NotImplementedError(
            "the %s op is not ported yet: the port runs loops unrolled at "
            "build time (models/transformer.py build_beam_infer)" % op_type)

    return layer


While = _not_ported("while")
cond = _not_ported("conditional_block")


def _make_compare(op_type):
    def layer(x, y, cond=None, force_cpu=None):
        helper = LayerHelper(op_type)
        out = cond or helper.create_variable_for_type_inference(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


def logical_and(x, y, out=None):
    """Elementwise and of two bool variables (the reference's
    ``layers/__init__.py:86``)."""
    helper = LayerHelper("logical_and")
    out = out or helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type="logical_and", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


less_than = _make_compare("less_than")
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
equal = _make_compare("equal")
not_equal = _make_compare("not_equal")
