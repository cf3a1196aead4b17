"""Sequence ops over the padded design: ``sequence_mask``.

Counterpart of ``paddle_tpu/ops/sequence.py`` (``sequence_mask:45``).
The reference keeps sequences padded to [B, T, ...] beside their lengths
in place of Fluid's LoD, and asks for a static ``maxlen`` (XLA's static
shapes); the port keeps the rule, so a program that runs on one package
runs on the other.
"""

import torch

from ..core.registry import register_op
from .common import attr_dtype


@register_op("sequence_mask", inputs=("X", "MaxLenTensor"), outputs=("Y",),
             attrs={"maxlen": -1, "out_dtype": 5},
             optional_inputs=("MaxLenTensor",), grad_maker=None)
def sequence_mask(ctx, x, maxlen_tensor, maxlen=-1, out_dtype=5):
    """Y[..., j] = j < X[...] for j < maxlen, in ``out_dtype``.  A
    MaxLenTensor is read on the host (a host sync of the step); without
    one, ``maxlen`` must be given (the reference raises on -1)."""
    if maxlen_tensor is not None:
        maxlen = int(ctx.host_item(maxlen_tensor))
    if maxlen < 0:
        raise ValueError(
            "sequence_mask needs a static maxlen (the reference's static "
            "shapes); pass maxlen explicitly")
    t = torch.arange(int(maxlen), device=x.device)
    return (t < x.unsqueeze(-1)).to(attr_dtype(out_dtype))
