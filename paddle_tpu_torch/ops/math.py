"""Dense math ops: mul, matmul, elementwise_add, scale.

Counterpart of ``paddle_tpu/ops/math.py`` (``mul:48``, ``matmul:66``,
``elementwise_add:140``, ``scale:151``).  The products are plain
``torch.matmul`` calls (cuBLAS on the card, in full f32: TF32 is off), as
the reference leaves them to XLA.
"""

import torch

from ..core.registry import register_op
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
