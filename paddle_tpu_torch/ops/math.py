"""Dense math ops: mul, matmul, elementwise_add, scale, sum, mean, and
the explicit grads of mul and elementwise_add.

Counterpart of ``paddle_tpu/ops/math.py`` (``mul:48``, ``matmul:66``,
``elementwise_add:140``, ``scale:151``, ``sum:163``, ``mean:172``).  The
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
