"""Op-building layers the BERT encoder calls.  Counterpart of
``paddle_tpu/layers/nn.py`` (``fc:133``, ``embedding:174``,
``matmul:199``, the elementwise layers ``:459-467``, ``scale:509``,
``layer_norm:1074``, ``fused_dropout_add_ln:1109``, ``dropout:707``,
``transpose:1217``,
``reshape:1232``, ``unsqueeze:1262``, ``flash_attention:1605``,
``softmax_with_cross_entropy:239``,
``sigmoid_cross_entropy_with_logits:257``, ``accuracy:368``,
``mean:502``, ``softmax:587``, ``concat:1292``, ``gather:1385``,
``relu:583``, ``conv2d:748``,
``conv2d_bn_relu:805``, ``pool2d:956``, ``batch_norm:1002``; for the
Transformer ``reduce_sum:493``, ``log_softmax:599``, ``pow:651``,
``label_smooth:729``, ``expand:1349``, ``slice:1359``,
``one_hot:1420``; for the LR schedules and the clips ``clip:534``,
``clip_by_norm:546`` and the activations of ``layers/__init__.py:30``;
for the control-flow programs and recurrent nets ``reduce_mean:494``,
``argmax:1472``, ``argmin:1482``, tanh, sigmoid and square; for the
recurrent layers and decoders ``topk:421``, ``squeeze:1247``,
``split:1304``, ``stack:1323`` and log).
Each
appends ops to the current block and names its variables and parameters
exactly as the reference does."""

import math

from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "matmul", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow",
           "elementwise_mod", "elementwise_floordiv", "scale",
           "layer_norm", "fused_dropout_add_ln", "dropout", "transpose",
           "reshape",
           "unsqueeze", "flash_attention", "concat", "gather",
           "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
           "mean", "softmax", "accuracy",
           "relu", "conv2d", "conv2d_bn_relu", "pool2d", "batch_norm",
           "reduce_sum", "log_softmax", "pow", "label_smooth", "expand",
           "slice", "one_hot", "sqrt", "exp", "floor", "ceil", "cos",
           "sign", "clip", "clip_by_norm", "reduce_mean", "argmax",
           "argmin", "tanh", "sigmoid", "square", "log", "topk", "squeeze",
           "split", "stack"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected: mul per input + sum + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_features = 1
        for d in inp.shape[num_flatten_dims:]:
            in_features *= int(d)
        w = helper.create_parameter(attr=pattr, shape=[in_features, size],
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(attr=param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": pad})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")
elementwise_mod = _elementwise_layer("elementwise_mod")
elementwise_floordiv = _elementwise_layer("elementwise_floordiv")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        """Reduce over ``dim`` (an int or a list), or over every dim when
        it is None."""
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is None:
            dim_attr, reduce_all = [0], True
        else:
            dim_attr = dim if isinstance(dim, (list, tuple)) else [dim]
            reduce_all = False
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]},
                         attrs={"dim": list(dim_attr), "keep_dim": keep_dim,
                                "reduce_all": reduce_all})
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")


def _arg_layer(op_type):
    def layer(x, axis=0):
        """The int64 index of the extreme along ``axis``."""
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="int64")
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return out

    return layer


argmax = _arg_layer("arg_max")
argmin = _arg_layer("arg_min")


def _unary_layer(op_type, x, attrs, name=None, dtype=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype or x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def _act_layer(op_type):
    """The reference's generated activation layer (``layers/__init__.py``
    ``_make_act_layer``): one op, X -> Out."""
    def layer(x, name=None):
        return _unary_layer(op_type, x, {}, name)

    layer.__name__ = op_type
    return layer


sqrt = _act_layer("sqrt")
exp = _act_layer("exp")
floor = _act_layer("floor")
ceil = _act_layer("ceil")
cos = _act_layer("cos")
sign = _act_layer("sign")
tanh = _act_layer("tanh")
sigmoid = _act_layer("sigmoid")
square = _act_layer("square")
log = _act_layer("log")


def topk(input, k, name=None):
    """(values, int64 indices) of the ``k`` largest along the last dim;
    ``k`` an int or a Variable."""
    from ..framework import Variable

    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64")
    inputs, attrs = {"X": [input]}, {}
    if isinstance(k, Variable):
        inputs["K"] = [k]
    else:
        attrs = {"k": k}
    helper.append_op(type="top_k", inputs=inputs,
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs=attrs)
    return values, indices


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal pieces along ``dim`` (an int), or pieces
    of the listed sizes."""
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "axis": dim, "sections": []}
        n_out = num_or_sections
    else:
        attrs = {"num": 0, "axis": dim, "sections": list(num_or_sections)}
        n_out = len(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(n_out)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def log_softmax(input, axis=-1, name=None):
    return _unary_layer("log_softmax", input, {"axis": axis}, name)


def pow(x, factor=1.0, name=None):
    return _unary_layer("pow", x, {"factor": factor}, name)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def expand(x, expand_times, name=None):
    return _unary_layer("expand", x, {"expand_times": list(expand_times)},
                        name)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    """f32 one-hot rows of ``depth`` (see the op for the shape rule)."""
    return _unary_layer("one_hot", input,
                        {"depth": depth,
                         "allow_out_of_range": allow_out_of_range},
                        dtype="float32")


def _norm_size(x, begin_norm_axis):
    n = 1
    for d in x.shape[begin_norm_axis:]:
        n *= int(d)
    return n


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    dtype = input.dtype
    norm_size = _norm_size(input, begin_norm_axis)
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=param_attr, shape=[norm_size], dtype=dtype,
            default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=bias_attr, shape=[norm_size], dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [var_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def fused_dropout_add_ln(x, y, dropout_prob=0.0, is_test=False,
                         begin_norm_axis=1, epsilon=1e-5, param_attr=None,
                         bias_attr=None, name=None, seed=None):
    """LayerNorm(x + dropout(y)) as one op, the transformer-encoder
    epilogue (upscale_in_train dropout)."""
    helper = LayerHelper("fused_dropout_add_ln", name=name)
    dtype = x.dtype
    norm_size = _norm_size(x, begin_norm_axis)
    scale_p = helper.create_parameter(attr=param_attr, shape=[norm_size],
                                      dtype=dtype,
                                      default_initializer=Constant(1.0))
    bias_p = helper.create_parameter(attr=bias_attr, shape=[norm_size],
                                     dtype=dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    r_out, mean_out, var_out = (
        helper.create_variable_for_type_inference(dtype, stop_gradient=True)
        for _ in range(3))
    seed_out = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(
        type="fused_dropout_add_ln",
        inputs={"X": [x], "Y": [y], "Scale": [scale_p], "Bias": [bias_p]},
        outputs={"Out": [out], "R": [r_out], "Mean": [mean_out],
                 "Variance": [var_out], "Seed": [seed_out]},
        attrs={"dropout_prob": float(dropout_prob), "is_test": is_test,
               "epsilon": epsilon, "begin_norm_axis": begin_norm_axis,
               "fix_seed": seed is not None, "seed": seed or 0})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Dropout of x with probability ``dropout_prob``; ``seed`` fixes the
    op's stream (fix_seed), else the executor's per-op seed keys it."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype="uint8",
                                                     stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "fix_seed": seed is not None,
                            "seed": seed if seed is not None else 0,
                            "dropout_implementation":
                                dropout_implementation})
    return out


def _shape_op(op_type, helper_name, x, attrs, name=None, act=None):
    """An op with Out + XShape (the grad ops' shape placeholder)."""
    helper = LayerHelper(helper_name, act=act, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs=attrs)
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    return _shape_op("transpose2", "transpose", x, {"axis": list(perm)},
                     name)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    return _shape_op("reshape2", "reshape2", x, {"shape": list(shape)}, name,
                     act)


def unsqueeze(input, axes, name=None):
    return _shape_op("unsqueeze2", "unsqueeze", input, {"axes": list(axes)},
                     name)


def flash_attention(q, k, v, bias_qk=None, causal=False, scale=0.0,
                    layout="BHSD", dropout_prob=0.0, is_test=False,
                    name=None):
    """Fused multi-head attention over [B, H, S, D] operands (the op runs
    the "BHSD" layout only); bias_qk is an additive mask [B, 1|H, Sq, Sk];
    scale 0 means 1/sqrt(head_dim)."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    mask = helper.create_variable_for_type_inference(dtype="uint8")
    mask.stop_gradient = True
    seed_out = helper.create_variable_for_type_inference(dtype="int32")
    seed_out.stop_gradient = True
    lse = helper.create_variable_for_type_inference(dtype="float32")
    lse.stop_gradient = True
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias_qk is not None:
        inputs["BiasQK"] = [bias_qk]
    helper.append_op(type="flash_attention", inputs=inputs,
                     outputs={"Out": [out], "Mask": [mask],
                              "Seed": [seed_out], "Lse": [lse]},
                     attrs={"causal": causal, "scale": float(scale),
                            "layout": layout,
                            "dropout_prob": float(dropout_prob),
                            "is_test": is_test})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index,
                            "numeric_stable_mode": numeric_stable_mode,
                            "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def _conv_filter(helper, input, num_filters, filter_size, groups,
                 param_attr, data_format):
    """The OIHW filter parameter, N(0, 2 / fan_in) by default; -> (filter,
    groups, [kh, kw])."""
    num_channels = input.shape[1] if data_format == "NCHW" \
        else input.shape[-1]
    groups = groups or 1
    filter_size = _pair(filter_size)
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=param_attr,
        shape=[num_filters, num_channels // groups] + filter_size,
        dtype=input.dtype,
        default_initializer=Normal(0.0, math.sqrt(2.0 / fan_in)))
    return w, groups


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    helper = LayerHelper("conv2d", bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    w, groups = _conv_filter(helper, input, num_filters, filter_size, groups,
                             param_attr, data_format)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "data_format": data_format})
    pre_act = pre_bias
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.kwargs.get("bias_attr"),
                                    shape=[num_filters], dtype=dtype,
                                    is_bias=True)
        if b is not None:
            pre_act = helper.create_variable_for_type_inference(dtype)
            helper.append_op(
                type="elementwise_add", inputs={"X": [pre_bias], "Y": [b]},
                outputs={"Out": [pre_act]},
                attrs={"axis": 1 if data_format == "NCHW" else 3})
    return helper.append_activation(pre_act)


def _bn_state(helper, c, dtype, param_attr, bias_attr, moving_mean_name,
              moving_variance_name):
    """Scale (1), Bias (0) and the running Mean (0) and Variance (1) of a
    batch norm over ``c`` channels, the running pair initialised once."""
    scale_p = helper.create_parameter(attr=param_attr, shape=[c],
                                      dtype=dtype,
                                      default_initializer=Constant(1.0))
    bias_p = helper.create_parameter(attr=bias_attr, shape=[c], dtype=dtype,
                                     is_bias=True,
                                     default_initializer=Constant(0.0))
    mean = helper.create_or_get_global_variable(
        name=moving_mean_name or helper.name + ".mean", shape=[c],
        dtype=dtype, persistable=True)
    mean.stop_gradient = True
    variance = helper.create_or_get_global_variable(
        name=moving_variance_name or helper.name + ".var", shape=[c],
        dtype=dtype, persistable=True)
    variance.stop_gradient = True
    if not getattr(mean, "_bn_initialized", False):
        Constant(0.0)(mean)
        Constant(1.0)(variance)
        mean._bn_initialized = True
        variance._bn_initialized = True
    return scale_p, bias_p, mean, variance


def conv2d_bn_relu(input, num_filters, filter_size, stride=1, padding=0,
                   dilation=1, groups=1, param_attr=None, bn_param_attr=None,
                   bn_bias_attr=None, act="relu", momentum=0.9, epsilon=1e-5,
                   is_test=False, moving_mean_name=None,
                   moving_variance_name=None, name=None, data_format="NCHW"):
    """One ``conv2d_bn_relu`` op for a conv (no bias: the BN absorbs it)
    + batch norm (+ relu); only act None or "relu"."""
    if act not in (None, "relu"):
        raise ValueError("conv2d_bn_relu supports act None or 'relu', got %r"
                         % (act,))
    helper = LayerHelper("conv2d_bn_relu", name=name)
    dtype = input.dtype
    w, groups = _conv_filter(helper, input, num_filters, filter_size, groups,
                             param_attr, data_format)
    scale_p, bias_p, mean, variance = _bn_state(
        helper, num_filters, dtype, bn_param_attr, bn_bias_attr,
        moving_mean_name, moving_variance_name)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_bn_relu",
        inputs={"Input": [input], "Filter": [w], "Scale": [scale_p],
                "Bias": [bias_p], "Mean": [mean], "Variance": [variance]},
        outputs={"Output": [out], "MeanOut": [mean],
                 "VarianceOut": [variance], "SavedMean": [saved_mean],
                 "SavedVariance": [saved_var]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "data_format": data_format, "momentum": momentum,
               "epsilon": epsilon, "is_test": is_test,
               "with_relu": act == "relu"})
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch norm over the channel axis (the port's statistics are exact:
    ``stat_subsample`` is 1, the reference's flag default)."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale_p, bias_p, mean, variance = _bn_state(
        helper, c, dtype, param_attr, bias_attr, moving_mean_name,
        moving_variance_name)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale_p], "Bias": [bias_p],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats, "stat_subsample": 1})
    return helper.append_activation(out)
