"""Activations: gelu, relu, softmax.  Counterpart of
``paddle_tpu/ops/activations.py`` (``gelu:136``, ``relu:20``,
``softmax:152``).  relu's gradient is written out (ResNet runs ~50 a
step, and a vjp replay costs ~0.6 ms of host each on the card); the
others' are the synthesized vjp replays."""

import torch
import torch.nn.functional as F

from ..core.registry import register_grad_lowering, register_op


@register_op("gelu", inputs=("X",), outputs=("Out",),
             attrs={"approximate": False})
def gelu(ctx, x, approximate=False):
    # the erf form by default (fluid's gelu op), the tanh form on request
    return F.gelu(x, approximate="tanh" if approximate else "none")


@register_op("relu", inputs=("X",), outputs=("Out",))
def relu(ctx, x):
    return torch.relu(x)


@register_grad_lowering("relu")
def relu_grad(ctx, x, out, dout):
    """dX = dOut where X > 0, else 0 (``jax.nn.relu``'s gradient, 0 at
    0)."""
    if dout is None:
        return (None,)
    return (torch.where(x > 0, dout, torch.zeros((), dtype=dout.dtype,
                                                 device=dout.device)),)


@register_op("softmax", inputs=("X",), outputs=("Out",),
             attrs={"axis": -1, "use_cudnn": False, "use_mkldnn": False})
def softmax(ctx, x, axis=-1, **_):
    if x.dtype == torch.bfloat16:  # f32 exp and sum, the carry dtype out
        return torch.softmax(x.float(), dim=axis).to(x.dtype)
    return torch.softmax(x, dim=axis)
