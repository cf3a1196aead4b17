"""Input declaration, constants and casts: ``data``,
``create_global_var``, ``assign``, ``fill_constant``,
``fill_constant_batch_size_like``, ``zeros``, ``cast``, and
``create_parameter`` and ``reverse``.  Counterpart of
``paddle_tpu/layers/tensor.py`` (``data:43``, ``create_parameter:71``,
``create_global_var:83``, ``cast:96``, ``assign:121``,
``fill_constant:154``, ``fill_constant_batch_size_like:169``,
``zeros:191``, ``reverse:218``)."""

import numpy as np

from ..framework import Variable, convert_np_dtype_to_dtype_
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..ops.common import dtype_enum
from ..utils import unique_name

__all__ = ["data", "create_parameter", "create_global_var", "assign",
           "fill_constant", "fill_constant_batch_size_like", "zeros", "cast",
           "reverse"]


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


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of ``shape``; ``name`` names it where ``attr`` does
    not."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global-block variable the startup program fills with ``value``."""
    helper = LayerHelper("global_var", name=name)
    var = helper.main_program.global_block().create_var(
        name=name or unique_name.generate(helper.name + ".tmp"),
        dtype=dtype, shape=list(shape), persistable=persistable)
    Constant(value)(var)
    return var


def assign(input, output=None):
    """A copy of a Variable (``assign``), or a numpy array as a constant
    of the program (``assign_value``, its values in the op's attrs)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
        return output
    arr = np.asarray(input)
    dtype = convert_np_dtype_to_dtype_(arr.dtype)
    if output is None:
        output = helper.create_variable_for_type_inference(dtype=dtype)
    key = {"float32": "fp32_values", "int32": "int32_values",
           "int64": "int64_values",
           "bool": "bool_values"}.get(dtype, "fp32_values")
    helper.append_op(
        type="assign_value", outputs={"Out": [output]},
        attrs={"shape": list(arr.shape), "dtype": dtype_enum(dtype),
               key: [float(v) if key == "fp32_values" else int(v)
                     for v in arr.flatten()]})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = convert_np_dtype_to_dtype_(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype_enum(dtype),
                            "value": float(value), "force_cpu": force_cpu})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  force_cpu=False):
    helper = LayerHelper("fill_constant_batch_size_like")
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype_enum(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0, force_cpu)


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": dtype_enum(x.dtype),
                            "out_dtype": dtype_enum(dtype)})
    return out


def reverse(x, axis):
    """x flipped along ``axis`` (an int or a list)."""
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": [axis] if isinstance(axis, int)
                            else list(axis)})
    return out
