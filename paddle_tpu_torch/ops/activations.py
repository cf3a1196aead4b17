"""Activations: gelu, relu, softmax.  Counterpart of
``paddle_tpu/ops/activations.py`` (``gelu:136``, ``relu:20``,
``softmax:152``).  Their gradients are the synthesized vjp replays."""

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu", inputs=("X",), outputs=("Out",),
             attrs={"approximate": False})
def gelu(ctx, x, approximate=False):
    # the erf form by default (fluid's gelu op), the tanh form on request
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register_op("relu", inputs=("X",), outputs=("Out",))
def relu(ctx, x):
    return torch.relu(x)


@register_op("softmax", inputs=("X",), outputs=("Out",),
             attrs={"axis": -1, "use_cudnn": False, "use_mkldnn": False})
def softmax(ctx, x, axis=-1, **_):
    if x.dtype == torch.bfloat16:  # f32 exp and sum, the carry dtype out
        return torch.softmax(x.float(), dim=axis).to(x.dtype)
    return torch.softmax(x, dim=axis)
