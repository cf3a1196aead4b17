"""Activations: gelu.  Counterpart of ``paddle_tpu/ops/activations.py``
(``gelu:136``)."""

import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu", inputs=("X",), outputs=("Out",),
             attrs={"approximate": False})
def gelu(ctx, x, approximate=False):
    # the erf form by default (fluid's gelu op), the tanh form on request
    return F.gelu(x, approximate="tanh" if approximate else "none")
