"""Normalisation and attention ops: layer_norm, flash_attention,
fused_dropout_add_ln.

Counterpart of ``paddle_tpu/ops/nn.py`` (``layer_norm:460``,
``flash_attention:863``, ``fused_dropout_add_ln:1018``).  Each reaches
its kernel wrapper, which launches the CUDA kernel on the card and runs
the plain version on the CPU.  Dropout (training) paths raise until the
training slice ports them.
"""

import torch

from ..core.registry import register_op
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_ln import fused_ln_fwd
from ..kernels.layer_norm import layer_norm_2d
from .common import training_only


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"),
             attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
             optional_inputs=("Scale", "Bias"))
def layer_norm(ctx, x, scale, bias, epsilon=1e-5, begin_norm_axis=1):
    lead = tuple(x.shape[:begin_norm_axis])
    tail = tuple(x.shape[begin_norm_axis:])
    rows, cols = 1, 1
    for d in lead:
        rows *= d
    for d in tail:
        cols *= d
    if scale is not None and bias is not None:
        y, m, v = layer_norm_2d(x.reshape(rows, cols), scale.reshape(cols),
                                bias.reshape(cols), epsilon)
        # Mean/Variance in x's dtype, as the reference's op emits them
        return (y.reshape(x.shape), m.to(x.dtype).reshape(lead),
                v.to(x.dtype).reshape(lead))
    # without Scale or Bias: the plain composition, f32 statistics
    axes = tuple(range(begin_norm_axis, x.dim()))
    xf = x.float()
    m = xf.mean(dim=axes, keepdim=True)
    v = ((xf - m) ** 2).mean(dim=axes, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + epsilon)
    if scale is not None:
        y = y * scale.reshape(tail)
    if bias is not None:
        y = y + bias.reshape(tail)
    return (y.to(x.dtype), m.to(x.dtype).reshape(lead),
            v.to(x.dtype).reshape(lead))


_PLACEHOLDERS = {}


def _placeholder(shape, dtype, device):
    """A zero tensor standing in an output slot that only the (not yet
    ported) backward reads; made once per device and shared, since no op
    writes it."""
    key = (shape, dtype, device)
    t = _PLACEHOLDERS.get(key)
    if t is None:
        t = _PLACEHOLDERS[key] = torch.zeros(shape, dtype=dtype,
                                             device=device)
    return t


def _fa_uses_dropout(dropout_prob, is_test):
    return float(dropout_prob or 0.0) > 0.0 and not is_test


@register_op("flash_attention", inputs=("Q", "K", "V", "BiasQK"),
             outputs=("Out", "Mask", "Seed", "Lse"),
             attrs={"causal": False, "scale": 0.0, "layout": "BHSD",
                    "dropout_prob": 0.0, "is_test": False},
             optional_inputs=("BiasQK",))
def flash_attention_op(ctx, q, k, v, bias_qk=None, causal=False, scale=0.0,
                       layout="BHSD", dropout_prob=0.0, is_test=False):
    """softmax(q k^T * scale + bias) v through the flash-attention kernel.
    q/k/v [B, H, S, D]; BiasQK [B, 1|H, Sq, Sk].  scale 0 means
    1/sqrt(head_dim).  Mask, Seed and Lse are the reference's placeholders
    of the dropout-free path (the backward that reads them comes with
    training)."""
    if layout != "BHSD":
        raise NotImplementedError(
            "flash_attention layout %r: the port runs BHSD (BERT's); the "
            "reference's BSHD composition is not ported yet" % (layout,))
    if _fa_uses_dropout(dropout_prob, is_test):
        # the reference's composed dropout path and its small-sequence
        # fused kernel (_fa_small_kernel_ok) both need dropout
        training_only(ctx, "flash_attention with dropout")
    sm_scale = scale if scale else q.shape[-1] ** -0.5
    out, _lse = flash_attention(q, k, v, bias=bias_qk, causal=causal,
                                sm_scale=sm_scale)
    dev = q.device
    return (out, _placeholder((1,), torch.uint8, dev),
            _placeholder((2,), torch.int32, dev),
            _placeholder((1, 1, 1, 1), torch.float32, dev))


@register_op("fused_dropout_add_ln", inputs=("X", "Y", "Scale", "Bias"),
             outputs=("Out", "R", "Mean", "Variance", "Seed"),
             attrs={"dropout_prob": 0.0, "is_test": False, "epsilon": 1e-5,
                    "begin_norm_axis": 1, "fix_seed": False, "seed": 0})
def fused_dropout_add_ln_op(ctx, x, y, scale, bias, dropout_prob=0.0,
                            is_test=False, epsilon=1e-5, begin_norm_axis=1,
                            fix_seed=False, seed=0, **_):
    """Out = LayerNorm(X + dropout(Y)) through the fused kernel; at
    inference (is_test, or p = 0) the dropout is the identity and Seed
    is zeros, as in the reference."""
    if not is_test and float(dropout_prob) > 0.0:
        training_only(ctx, "fused_dropout_add_ln with dropout")
    z, r, mean, var = fused_ln_fwd(x, y, scale, bias, 0.0, None, epsilon,
                                   begin_norm_axis)
    return z, r, mean, var, _placeholder((2,), torch.int32, x.device)
