"""Dense math ops: mul, matmul, elementwise_add, scale, sum, mean, the
explicit grads of mul and elementwise_add, and the two ops the
predictor's passes emit, fc and fused_elemwise_activation.

Counterpart of ``paddle_tpu/ops/math.py`` (``mul:48``, ``matmul:66``,
``elementwise_add:140``, ``scale:151``, ``sum:163``, ``mean:172``) and
of ``paddle_tpu/ops/coverage_tail.py`` (``fc:92``,
``fused_elemwise_activation:469``).  The
products are plain ``torch.matmul`` calls (cuBLAS on the card, in full
f32: TF32 is off), as the reference leaves them to XLA.  The reference
differentiates mul and elementwise_add by replaying them under
``jax.vjp``, where XLA drops the replayed product; an eager replay would
pay it, so the port's ``mul_grad`` and ``elementwise_add_grad`` are
written out.
"""

import torch

from ..core.registry import register_grad_lowering, register_op, wants_grad
from .common import bcast_y


def _flatten2d(x, num_col_dims):
    lead = 1
    for d in x.shape[:num_col_dims]:
        lead *= d
    return x.reshape(lead, -1)


@register_op("mul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1,
                    "scale_x": 1.0, "scale_y": [1.0], "scale_out": 1.0,
                    "force_fp32_output": False})
def mul(ctx, x, y, x_num_col_dims=1, y_num_col_dims=1, **_):
    """Fluid's flatten-to-2D product (mul_op.cc:37); the output keeps the
    unflattened leading dims of x and trailing dims of y."""
    out = torch.matmul(_flatten2d(x, x_num_col_dims),
                       _flatten2d(y, y_num_col_dims))
    return out.reshape(tuple(x.shape[:x_num_col_dims])
                       + tuple(y.shape[y_num_col_dims:]))


@register_op("matmul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"transpose_X": False, "transpose_Y": False,
                    "alpha": 1.0, "head_number": 1})
def matmul(ctx, x, y, transpose_X=False, transpose_Y=False, alpha=1.0,
           head_number=1):
    if transpose_X and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_Y and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return out


@register_op("elementwise_add", inputs=("X", "Y"), outputs=("Out",),
             attrs={"axis": -1})
def elementwise_add(ctx, x, y, axis=-1):
    return x + bcast_y(x, y, axis)


@register_op("scale", inputs=("X", "ScaleTensor"), outputs=("Out",),
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True},
             optional_inputs=("ScaleTensor",))
def scale(ctx, x, scale_tensor, scale=1.0, bias=0.0, bias_after_scale=True):
    s = scale_tensor.reshape(()) if scale_tensor is not None else scale
    if bias_after_scale:
        return x * s + bias
    return (x + bias) * s


@register_op("sum", inputs=("X",), outputs=("Out",),
             duplicable_inputs=("X",))
def sum_op(ctx, xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ctx, x):
    return x.mean().reshape(1)


@register_grad_lowering("mul")
def mul_grad(ctx, x, y, out, dout, x_num_col_dims=1, y_num_col_dims=1,
             **_):
    """dX = dOut . Y^T and dY = X^T . dOut over the flattened 2-D views,
    reshaped back; only the gradients the op writes are computed."""
    x2 = _flatten2d(x, x_num_col_dims)
    y2 = _flatten2d(y, y_num_col_dims)
    d2 = dout.reshape(x2.shape[0], y2.shape[1])
    dx = torch.matmul(d2, y2.t()).reshape(x.shape) \
        if wants_grad(ctx, "X") else None
    dy = torch.matmul(x2.t(), d2).reshape(y.shape) \
        if wants_grad(ctx, "Y") else None
    return dx, dy


def _unbroadcast(g, shape):
    """Sum ``g`` over the dims a broadcast added to a tensor of
    ``shape``, back to ``shape``."""
    if tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, n in enumerate(shape)
                                if n == 1 and g.shape[lead + i] != 1]
    return g.sum(dim=dims, keepdim=True).reshape(shape) if dims \
        else g.reshape(shape)


@register_grad_lowering("elementwise_add")
def elementwise_add_grad(ctx, x, y, out, dout, axis=-1):
    dx = _unbroadcast(dout, x.shape) if wants_grad(ctx, "X") else None
    dy = None
    if wants_grad(ctx, "Y"):
        yb = bcast_y(x, y, axis)  # y as the forward broadcast it
        dy = _unbroadcast(dout, yb.shape).reshape(y.shape)
    return dx, dy


# -- ops of the inference passes (ir.py) ------------------------------------


@register_op("fc", inputs=("Input", "W", "Bias"), outputs=("Out",),
             attrs={"in_num_col_dims": 1, "activation_type": "",
                    "use_mkldnn": False, "padding_weights": False},
             optional_inputs=("Bias",))
def fc(ctx, x, w, bias=None, in_num_col_dims=1, activation_type="", **_):
    """What ``fc_fuse_pass`` makes of mul + elementwise_add (+ relu): x
    flattened to 2-D at ``in_num_col_dims``, times w, plus the bias row."""
    out = torch.matmul(_flatten2d(x, in_num_col_dims), w)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    if activation_type == "relu":
        out = torch.relu(out)
    return out.reshape(tuple(x.shape[:in_num_col_dims]) + (w.shape[-1],))


_FUSED_ACTS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid, "identity": lambda v: v,
               "": lambda v: v}


@register_op("fused_elemwise_activation", inputs=("X", "Y"),
             outputs=("Out", "IntermediateOut"),
             attrs={"functor_list": [], "axis": -1, "scale": 1.0,
                    "save_intermediate_out": False})
def fused_elemwise_activation(ctx, x, y, functor_list=(), axis=-1,
                              scale=1.0, save_intermediate_out=False):
    """f1(f2(x, y)) over {elementwise_add, elementwise_mul} x {relu, tanh,
    sigmoid, scale, identity}, as the reference composes it; -> (Out, the
    inner result)."""

    def apply_one(name, a, b=None):
        if name == "elementwise_add":
            return a + bcast_y(a, b, axis)
        if name == "elementwise_mul":
            return a * bcast_y(a, b, axis)
        if name == "scale":
            return a * scale
        return _FUSED_ACTS[name](a)

    f1, f2 = (list(functor_list) + ["identity", "identity"])[:2]
    if f2.startswith("elementwise_"):
        inter = apply_one(f2, x, y)
        return apply_one(f1, inter), inter
    inter = apply_one(f2, y)
    return apply_one(f1, x, inter), inter
