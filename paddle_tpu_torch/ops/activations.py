"""Activations: gelu, relu, pow, softmax, log_softmax, and the unary ops
the LR schedules, the clips and L1 decay build from (exp, sqrt, cos,
ceil, floor, sign), and tanh, sigmoid and square, which the recurrent
nets and the MLPs of the control-flow programs use, and log, which the
contrib beam decoder takes of its softmax.  Counterpart of ``paddle_tpu/ops/activations.py``
(``gelu:136``, ``relu:20``, ``pow:146``, ``softmax:152``,
``log_softmax:163``, the unary table ``:23-51``); a bf16 input (the
AMP policy's activations) is computed in f32 and returned in bf16 by
gelu and softmax, as there.  relu's gradient is written out (ResNet runs
~50 a step, and a vjp replay costs ~0.6 ms of host each on the card);
the others' are the synthesized vjp replays."""

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_grad_lowering, register_op

_SQRT_HALF = math.sqrt(0.5)


@register_op("gelu", inputs=("X",), outputs=("Out",),
             attrs={"approximate": False})
def gelu(ctx, x, approximate=False):
    # the erf form by default (fluid's gelu op), the tanh form on request.
    # A bf16 x (the AMP policy's activations) is computed in f32 and
    # rounded once, as the reference's _gelu_bf16 (its grad replays the
    # same composition); the erf form as jax.nn.gelu writes it, with
    # erfc, which keeps the tail x < -3 where 1 + erf(x) cancels (F.gelu's
    # f32 there is off by up to 60%, many bf16 ulps)
    if x.dtype == torch.bfloat16:
        xf = x.float()
        if approximate:
            return F.gelu(xf, approximate="tanh").to(x.dtype)
        return (xf * (torch.special.erfc(xf * -_SQRT_HALF) / 2)).to(x.dtype)
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
    dout = dout.to(out.dtype)  # the replay's cotangent dtype
    return (torch.where(x > 0, dout, torch.zeros((), dtype=dout.dtype,
                                                 device=dout.device)),)


@register_op("softmax", inputs=("X",), outputs=("Out",),
             attrs={"axis": -1, "use_cudnn": False, "use_mkldnn": False})
def softmax(ctx, x, axis=-1, **_):
    if x.dtype == torch.bfloat16:  # f32 exp and sum, the carry dtype out
        return torch.softmax(x.float(), dim=axis).to(x.dtype)
    return torch.softmax(x, dim=axis)


@register_op("pow", inputs=("X",), outputs=("Out",), attrs={"factor": 1.0})
def pow_op(ctx, x, factor=1.0):
    return torch.pow(x, factor)


@register_op("log_softmax", inputs=("X",), outputs=("Out",),
             attrs={"axis": -1})
def log_softmax(ctx, x, axis=-1):
    return torch.log_softmax(x, dim=axis)


_UNARY = {"exp": torch.exp, "sqrt": torch.sqrt, "cos": torch.cos,
          "ceil": torch.ceil, "floor": torch.floor, "sign": torch.sign,
          "tanh": torch.tanh, "sigmoid": torch.sigmoid,
          "square": torch.square, "log": torch.log}


def _unary(fn):
    def lower(ctx, x):
        return fn(x)

    return lower


for _name, _fn in _UNARY.items():
    register_op(_name, inputs=("X",), outputs=("Out",))(_unary(_fn))
