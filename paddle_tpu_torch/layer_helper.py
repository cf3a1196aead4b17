"""LayerHelper: parameter, temp-variable, bias and activation plumbing for
layers; the port's copy of ``paddle_tpu/layer_helper.py``, which names
everything the same way so both packages build identical programs."""

from .framework import (Parameter, default_main_program,
                        default_startup_program)
from .initializer import Constant, Xavier
from .param_attr import ParamAttr
from .utils import unique_name

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None \
            else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def input_dtype(self, input_param_name="input"):
        inputs = self.kwargs[input_param_name]
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("mixed input dtypes: %s vs %s"
                                 % (dtype, each.dtype))
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.name is None:
            attr.name = unique_name.generate(
                "%s.%s" % (self.name, "b" if is_bias else "w"))
        # a parameter name reused across layers resolves to the one
        # existing Parameter (one init op in the startup program)
        existing = self.main_program.global_block().vars.get(attr.name)
        if existing is not None:
            if not isinstance(existing, Parameter):
                raise ValueError("variable %r already exists and is not a "
                                 "Parameter" % attr.name)
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    "shared parameter %r re-requested with shape %s != %s"
                    % (attr.name, list(shape), list(existing.shape)))
            return existing
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else Xavier()
        init = attr.initializer or default_initializer
        param = self.block.create_parameter(
            shape=shape, dtype=dtype, initializer=init, **attr._to_kwargs())
        init(param)  # appends the init op to the startup program
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    def create_or_get_global_variable(self, name, **kwargs):
        gblock = self.main_program.global_block()
        if gblock.has_var(name):
            return gblock.vars[name]
        return gblock.create_var(name=name, **kwargs)

    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var, act=None):
        if act is None:
            act = self.kwargs.get("act")
        if act is None:
            return input_var
        act = {"type": act} if isinstance(act, str) else dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
