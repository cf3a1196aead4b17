"""Normalisation and attention ops and their gradients: layer_norm,
flash_attention, fused_dropout_add_ln.

Counterpart of ``paddle_tpu/ops/nn.py`` (``layer_norm:460``,
``flash_attention:863`` and its grad op ``:941``,
``fused_dropout_add_ln:1018`` and its grad op ``:1063``).  Each reaches
its kernel wrapper, which launches the CUDA kernel on the card and runs
the plain version on the CPU.  The grads are written out (a vjp replay
cannot trace a ctypes kernel): ``layer_norm_grad`` in plain torch from
the forward's statistics (the reference's own backward is the jnp pass
of ``pallas_kernels/layer_norm.py``), ``flash_attention_grad`` and
``fused_dropout_add_ln_grad`` through the backward kernels.  Dropout
paths raise: the port has no dropout stream yet.
"""

import torch

from ..core.registry import (GradOpDesc, register_grad_lowering, register_op,
                             wants_grad)
from ..framework import _grad_var_name
from ..kernels.flash_attention import flash_attention, flash_attention_bwd
from ..kernels.fused_ln import fused_ln_bwd, fused_ln_fwd
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


@register_grad_lowering("layer_norm")
def layer_norm_grad(ctx, x, scale, bias, y, dy, mean, dmean, var, dvar,
                    epsilon=1e-5, begin_norm_axis=1):
    """dX, dScale, dBias from the forward's Mean and Variance.  Mean and
    Variance are stop-gradient outputs: no gradient flows into them."""
    if dmean is not None or dvar is not None:
        raise NotImplementedError(
            "layer_norm_grad through the Mean/Variance outputs")
    if dy is None:
        return None, None, None
    tail = tuple(x.shape[begin_norm_axis:])
    cols = 1
    for d in tail:
        cols *= d
    x2 = x.reshape(-1, cols).float()
    rstd = torch.rsqrt(var.reshape(-1, 1).float() + epsilon)
    xhat = (x2 - mean.reshape(-1, 1).float()) * rstd
    d = dy.reshape(-1, cols).float()
    dscale = (d * xhat).sum(dim=0).reshape(scale.shape).to(scale.dtype) \
        if scale is not None and wants_grad(ctx, "Scale") else None
    dbias = d.sum(dim=0).reshape(bias.shape).to(bias.dtype) \
        if bias is not None and wants_grad(ctx, "Bias") else None
    dx = None
    if wants_grad(ctx, "X"):
        a = d * scale.reshape(1, cols).float() if scale is not None else d
        dx = rstd * (a - a.mean(dim=1, keepdim=True)
                     - xhat * (a * xhat).mean(dim=1, keepdim=True))
        dx = dx.reshape(x.shape).to(x.dtype)
    return dx, dscale, dbias


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


def _flash_attention_grad_maker(op, no_grad_set):
    inputs = {"Q": list(op.input("Q")), "K": list(op.input("K")),
              "V": list(op.input("V")), "Mask": list(op.output("Mask")),
              "Out": list(op.output("Out")), "Seed": list(op.output("Seed")),
              "Lse": list(op.output("Lse")),
              "GRAD@Out": [_grad_var_name(op.output("Out")[0])]}
    if op.input("BiasQK"):
        inputs["BiasQK"] = list(op.input("BiasQK"))
    outputs = {}
    for slot in ("Q", "K", "V"):
        n = op.input(slot)[0]
        if n not in no_grad_set:
            outputs["X@" + slot] = [_grad_var_name(n)]
    if not outputs:
        return []
    return [GradOpDesc("flash_attention_grad", inputs, outputs,
                       dict(op.attrs))]


def _check_layout(layout):
    if layout != "BHSD":
        raise NotImplementedError(
            "flash_attention layout %r: the port runs BHSD (BERT's); the "
            "reference's BSHD composition is not ported yet" % (layout,))


@register_op("flash_attention", inputs=("Q", "K", "V", "BiasQK"),
             outputs=("Out", "Mask", "Seed", "Lse"),
             attrs={"causal": False, "scale": 0.0, "layout": "BHSD",
                    "dropout_prob": 0.0, "is_test": False},
             optional_inputs=("BiasQK",), no_grad_inputs=("BiasQK",),
             grad_maker=_flash_attention_grad_maker)
def flash_attention_op(ctx, q, k, v, bias_qk=None, causal=False, scale=0.0,
                       layout="BHSD", dropout_prob=0.0, is_test=False):
    """softmax(q k^T * scale + bias) v through the flash-attention kernel.
    q/k/v [B, H, S, D]; BiasQK [B, 1|H, Sq, Sk].  scale 0 means
    1/sqrt(head_dim).  Mask, Seed and Lse are the reference's placeholders
    of the dropout-free path; the grad op recomputes the lse."""
    _check_layout(layout)
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


@register_op("flash_attention_grad",
             inputs=("Q", "K", "V", "BiasQK", "Mask", "Out", "Seed", "Lse",
                     "GRAD@Out"),
             outputs=("X@Q", "X@K", "X@V"),
             attrs={"causal": False, "scale": 0.0, "layout": "BHSD",
                    "dropout_prob": 0.0, "is_test": False},
             optional_inputs=("BiasQK",), grad_maker=None)
def flash_attention_grad_op(ctx, q, k, v, bias_qk, mask, out, seed_words,
                            lse, dy, causal=False, scale=0.0, layout="BHSD",
                            dropout_prob=0.0, is_test=False):
    """dQ, dK, dV through the backward kernels.  The forward's Lse output
    is the reference's placeholder (programs stay the reference's), so
    the forward kernel runs again for the out/lse pair, as the
    reference's ``jax.vjp`` replays the forward."""
    _check_layout(layout)
    if _fa_uses_dropout(dropout_prob, is_test):
        training_only(ctx, "flash_attention_grad with dropout")
    if dy is None:
        return None, None, None
    sm_scale = scale if scale else q.shape[-1] ** -0.5
    out2, lse2 = flash_attention(q, k, v, bias=bias_qk, causal=causal,
                                 sm_scale=sm_scale)
    dq, dk, dv = flash_attention_bwd(q, k, v, bias_qk, out2, lse2, dy,
                                     causal, sm_scale)
    return tuple(g if wants_grad(ctx, s) else None
                 for g, s in zip((dq, dk, dv), "QKV"))


def _fused_dropout_add_ln_grad_maker(op, no_grad_set):
    inputs = {"R": list(op.output("R")), "Scale": list(op.input("Scale")),
              "Seed": list(op.output("Seed")),
              "Mean": list(op.output("Mean")),
              "Variance": list(op.output("Variance")),
              "GRAD@Out": [_grad_var_name(op.output("Out")[0])]}
    outputs = {}
    for slot in ("X", "Y", "Scale", "Bias"):
        n = op.input(slot)[0]
        if n not in no_grad_set:
            outputs["X@" + slot] = [_grad_var_name(n)]
    if not outputs:
        return []
    return [GradOpDesc("fused_dropout_add_ln_grad", inputs, outputs,
                       dict(op.attrs))]


@register_op("fused_dropout_add_ln", inputs=("X", "Y", "Scale", "Bias"),
             outputs=("Out", "R", "Mean", "Variance", "Seed"),
             attrs={"dropout_prob": 0.0, "is_test": False, "epsilon": 1e-5,
                    "begin_norm_axis": 1, "fix_seed": False, "seed": 0},
             grad_maker=_fused_dropout_add_ln_grad_maker)
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


@register_op("fused_dropout_add_ln_grad",
             inputs=("R", "Scale", "Seed", "Mean", "Variance", "GRAD@Out"),
             outputs=("X@X", "X@Y", "X@Scale", "X@Bias"),
             attrs={"dropout_prob": 0.0, "is_test": False, "epsilon": 1e-5,
                    "begin_norm_axis": 1, "fix_seed": False, "seed": 0},
             grad_maker=None)
def fused_dropout_add_ln_grad_op(ctx, r, scale, seed_words, mean, var, dz,
                                 dropout_prob=0.0, is_test=False,
                                 epsilon=1e-5, begin_norm_axis=1, **_):
    """dX, dY, dScale, dBias from the saved residual sum R and the row
    statistics, through the fused-LN backward kernel."""
    p = 0.0 if is_test else float(dropout_prob)
    if p > 0.0:
        training_only(ctx, "fused_dropout_add_ln_grad with dropout")
    return fused_ln_bwd(r, scale, mean, var, dz, 0.0, None, epsilon,
                        begin_norm_axis)
