"""Comparison layers, which the reference keeps in its control-flow
module.  Counterpart of ``paddle_tpu/layers/control_flow.py``
(``_make_compare:145``)."""

from ..layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"]


def _make_compare(op_type):
    def layer(x, y, cond=None, force_cpu=None):
        helper = LayerHelper(op_type)
        out = cond or helper.create_variable_for_type_inference(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


less_than = _make_compare("less_than")
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
equal = _make_compare("equal")
not_equal = _make_compare("not_equal")
