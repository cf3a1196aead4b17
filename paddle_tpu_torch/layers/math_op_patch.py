"""Operators on Variable: ``a + b``, ``a >= b``, ... append the matching
elementwise or comparison op.  Counterpart of
``paddle_tpu/layers/math_op_patch.py`` (the table ``:5-22``); ``==``
keeps identity, so Variables stay usable as dict keys."""

from ..framework import Variable
from ..layer_helper import LayerHelper

_SUPPORTED = [
    ("__add__", "elementwise_add", False),
    ("__radd__", "elementwise_add", True),
    ("__sub__", "elementwise_sub", False),
    ("__rsub__", "elementwise_sub", True),
    ("__mul__", "elementwise_mul", False),
    ("__rmul__", "elementwise_mul", True),
    ("__truediv__", "elementwise_div", False),
    ("__rtruediv__", "elementwise_div", True),
    ("__pow__", "elementwise_pow", False),
    ("__mod__", "elementwise_mod", False),
    ("__floordiv__", "elementwise_floordiv", False),
    ("__lt__", "less_than", False),
    ("__le__", "less_equal", False),
    ("__gt__", "greater_than", False),
    ("__ge__", "greater_equal", False),
]

_COMPARES = ("less_than", "less_equal", "greater_than", "greater_equal",
             "equal", "not_equal")


def _scalar_to_var(val, ref):
    from . import tensor

    return tensor.fill_constant([1], ref.dtype, float(val))


def _binary(op_type, reverse):
    def impl(self, other):
        if not isinstance(other, Variable):
            if not isinstance(other, (int, float)):
                return NotImplemented
            # a scalar: one scale op for x + c and x * c, as the reference
            from .nn import scale

            if op_type == "elementwise_add" and not reverse:
                return scale(self, scale=1.0, bias=float(other))
            if op_type == "elementwise_mul":
                return scale(self, scale=float(other))
            other = _scalar_to_var(other, self)
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        is_cmp = op_type in _COMPARES
        out = helper.create_variable_for_type_inference(
            dtype="bool" if is_cmp else x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]},
                         attrs={} if is_cmp else {"axis": -1})
        return out

    return impl


def _neg(self):
    from .nn import scale

    return scale(self, scale=-1.0)


def monkey_patch_variable():
    for name, op_type, rev in _SUPPORTED:
        setattr(Variable, name, _binary(op_type, rev))
    Variable.__neg__ = _neg


monkey_patch_variable()
