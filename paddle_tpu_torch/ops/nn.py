"""Normalisation, dropout and attention ops and their gradients:
layer_norm, dropout, flash_attention, fused_dropout_add_ln.

Counterpart of ``paddle_tpu/ops/nn.py`` (``layer_norm:460``,
``dropout:602`` and its grad op ``:634``, ``flash_attention:863`` and its
grad op ``:941``, ``fused_dropout_add_ln:1018`` and its grad op
``:1063``).  Each reaches its kernel wrapper, which launches the CUDA
kernel on the card and runs the plain version on the CPU.  The grads are
written out (a vjp replay cannot trace a ctypes kernel):
``layer_norm_grad`` in plain torch from the forward's statistics (the
reference's own backward is the jnp pass of
``pallas_kernels/layer_norm.py``), ``dropout_grad`` from the saved Mask,
``flash_attention_grad`` and ``fused_dropout_add_ln_grad`` through the
backward kernels.

Randomness.  An op whose dropout is active draws from the port's Philox
stream (``kernels/philox.py``) keyed by two words derived on the host
from the op's seed (``LowerCtx.seed_words``: program seed, step, op
index; the ``seed`` attr under ``fix_seed``), so the card and the CPU
draw the same masks.  Two quantisations, as in the reference: the
``dropout`` op and the composed attention keep iff a byte of the stream
< round(q 256) and divide by ``realized_keep_prob``; the fused kernels
keep iff a u32 < round(q 2^32) and multiply by its inverse in f32.
"""

import torch

from .. import flags
from ..core.registry import (GradOpDesc, register_grad_lowering, register_op,
                             wants_grad)
from ..framework import _grad_var_name
from ..kernels import philox
from ..kernels.dropout import dropout as dropout_kernel, true_divide
from ..kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                       small_attention_bwd,
                                       small_attention_fwd,
                                       small_attention_shapes_ok)
from ..kernels.fused_ln import fused_ln_bwd, fused_ln_fwd
from ..kernels.layer_norm import layer_norm_2d
from .common import byte_threshold, realized_keep_prob


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
    """A zero tensor standing in an output slot that no op reads on this
    path (the reference emits the same placeholders); made once per
    device and shared, since no op writes it."""
    key = (shape, dtype, device)
    t = _PLACEHOLDERS.get(key)
    if t is None:
        t = _PLACEHOLDERS[key] = torch.zeros(shape, dtype=dtype,
                                             device=device)
    return t


def _seed_words(ctx, fix_seed, seed):
    """The op's two Philox key words: from its ``seed`` attr under
    ``fix_seed``, else from the executor's per-op seed."""
    if fix_seed and not ctx.abstract:
        return philox.words_of(seed)
    return ctx.seed_words()


def _seed_output(device):
    """The op's Seed output, int32 [2]: the forward's kernel (or its plain
    version) stores the key words into it, so the host never copies them
    to the card."""
    return torch.empty(2, dtype=torch.int32, device=device)


# -- dropout -----------------------------------------------------------------


def _dropout_grad_maker(op, no_grad_set):
    x = op.input("X")[0]
    if x in no_grad_set:
        return []
    return [GradOpDesc("dropout_grad",
                       {"Mask": list(op.output("Mask")),
                        "GRAD@Out": [_grad_var_name(op.output("Out")[0])]},
                       {"X@X": [_grad_var_name(x)]}, dict(op.attrs))]


_DROPOUT_ATTRS = {"dropout_prob": 0.5, "is_test": False, "fix_seed": False,
                  "seed": 0, "dropout_implementation": "downgrade_in_infer"}


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"),
             attrs=_DROPOUT_ATTRS, grad_maker=_dropout_grad_maker, n_rng=1)
def dropout(ctx, x, dropout_prob=0.5, is_test=False, fix_seed=False, seed=0,
            dropout_implementation="downgrade_in_infer", **_):
    """Training: keep iff a byte of the stream < round(q 256), q = 1 - p;
    upscale_in_train divides the kept values by the realized keep
    probability, downgrade_in_infer keeps them as they are; Mask (uint8)
    is what the grad op reads.  Inference: the identity
    (upscale_in_train) or x * (1 - p) at the nominal p
    (downgrade_in_infer), Mask all ones."""
    if is_test:
        ones = torch.ones(x.shape, dtype=torch.uint8, device=x.device)
        if dropout_implementation == "upscale_in_train":
            return x, ones
        return x * (1.0 - dropout_prob), ones
    keep_prob = 1.0 - dropout_prob
    return dropout_kernel(x, _seed_words(ctx, fix_seed, seed),
                          byte_threshold(keep_prob),
                          realized_keep_prob(keep_prob),
                          dropout_implementation == "upscale_in_train")


def _dropout_active(attrs):
    return not attrs.get("is_test", False)


dropout.opdef.rng_when = _dropout_active


@register_op("dropout_grad", inputs=("Mask", "GRAD@Out"), outputs=("X@X",),
             attrs=_DROPOUT_ATTRS, grad_maker=None)
def dropout_grad(ctx, mask, dy, dropout_prob=0.5, is_test=False,
                 dropout_implementation="downgrade_in_infer", **_):
    """dX = dY * Mask, divided by the forward's realized keep probability
    under upscale_in_train."""
    if dy is None:
        return None
    m = mask.to(dy.dtype)
    if dropout_implementation == "upscale_in_train":
        return true_divide(dy * m, realized_keep_prob(1.0 - dropout_prob))
    return dy * m


# -- flash_attention ---------------------------------------------------------


def _uses_dropout(attrs):
    """Dropout is active in flash_attention and fused_dropout_add_ln."""
    return (float(attrs.get("dropout_prob", 0.0) or 0.0) > 0.0
            and not attrs.get("is_test", False))


def _fa_small_route(q, k, bias, attrs):
    """Routing predicate of the small-sequence kernels, shared by the
    forward and the grad lowering: both MUST route identically, since the
    grad re-draws the forward's mask from Seed.  The reference also asks
    for a TPU backend; here the device decides only inside the kernel
    wrapper (a CPU tensor takes the plain version), so both lowerings
    still route alike."""
    if not flags.flag("FLAGS_fused_small_attention") \
            or not _uses_dropout(attrs):
        return False
    return small_attention_shapes_ok(
        tuple(q.shape), tuple(k.shape),
        None if bias is None else tuple(bias.shape),
        attrs.get("causal", False), attrs.get("layout", "BHSD"))


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


def _composed_probs(q, k, bias, causal, sm_scale):
    """softmax(q k^T * scale + bias) as the reference's
    ``_attention_composed`` computes it (the softmax in f32)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    if causal:
        sq, sk = s.shape[-2:]
        above = torch.arange(sk, device=s.device)[None, :] \
            > torch.arange(sq, device=s.device)[:, None]
        s = s.masked_fill(above, -1e30)
    return torch.softmax(s.float(), dim=-1).to(q.dtype)


_FA_ATTRS = {"causal": False, "scale": 0.0, "layout": "BHSD",
             "dropout_prob": 0.0, "is_test": False}


@register_op("flash_attention", inputs=("Q", "K", "V", "BiasQK"),
             outputs=("Out", "Mask", "Seed", "Lse"), attrs=_FA_ATTRS,
             optional_inputs=("BiasQK",), no_grad_inputs=("BiasQK",),
             grad_maker=_flash_attention_grad_maker, n_rng=1)
def flash_attention_op(ctx, q, k, v, bias_qk=None, causal=False, scale=0.0,
                       layout="BHSD", dropout_prob=0.0, is_test=False):
    """softmax(q k^T * scale + bias) v, q/k/v [B, H, S, D], BiasQK [B,
    1|H, Sq, Sk], scale 0 meaning 1/sqrt(head_dim).  Three routes, as the
    reference's:

    * small-sequence kernel (``FLAGS_fused_small_attention``, dropout
      active, ``small_attention_shapes_ok``): bias, softmax and dropout
      in one kernel; Seed and Lse carry the backward's replay state;
    * composed, with dropout active otherwise: softmax, the dropout
      kernel's byte draw (upscale by ``realized_keep_prob``), the product;
      the keep Mask is saved for the grad;
    * flash attention without dropout; Mask, Seed and Lse are the
      reference's placeholders (the grad recomputes the lse)."""
    _check_layout(layout)
    sm_scale = scale if scale else q.shape[-1] ** -0.5
    attrs = {"dropout_prob": dropout_prob, "is_test": is_test,
             "causal": causal, "layout": layout}
    dev = q.device
    if _fa_small_route(q, k, bias_qk, attrs):
        seed_t = _seed_output(dev)
        out, lse = small_attention_fwd(q, k, v, bias_qk, sm_scale,
                                       dropout_prob, ctx.seed_words(),
                                       seed_out=seed_t)
        return out, _placeholder((1,), torch.uint8, dev), seed_t, lse
    seed_ph = _placeholder((2,), torch.int32, dev)
    lse_ph = _placeholder((1, 1, 1, 1), torch.float32, dev)
    if _uses_dropout(attrs):
        keep_prob = 1.0 - dropout_prob
        p = _composed_probs(q, k, bias_qk, causal, sm_scale)
        pd, mask = dropout_kernel(p, ctx.seed_words(),
                                  byte_threshold(keep_prob),
                                  realized_keep_prob(keep_prob), True)
        return torch.einsum("bhqk,bhkd->bhqd", pd, v), mask, seed_ph, lse_ph
    out, _lse = flash_attention(q, k, v, bias=bias_qk, causal=causal,
                                sm_scale=sm_scale)
    return out, _placeholder((1,), torch.uint8, dev), seed_ph, lse_ph


flash_attention_op.opdef.rng_when = _uses_dropout


def _composed_grad(q, k, v, bias, mask, dy, causal, sm_scale, keep_prob):
    """dQ, dK, dV of the composed route from its saved keep Mask: the
    softmax recomputed, the dropout replayed with the mask."""
    p = _composed_probs(q, k, bias, causal, sm_scale)
    kq = realized_keep_prob(keep_prob)
    keep = mask.bool()
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    pd = torch.where(keep, true_divide(p, kq), zero)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, dy)
    dp = torch.where(keep, true_divide(torch.einsum("bhqd,bhkd->bhqk", dy, v),
                                       kq), zero)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    return dq, dk, dv


@register_op("flash_attention_grad",
             inputs=("Q", "K", "V", "BiasQK", "Mask", "Out", "Seed", "Lse",
                     "GRAD@Out"),
             outputs=("X@Q", "X@K", "X@V"), attrs=_FA_ATTRS,
             optional_inputs=("BiasQK",), grad_maker=None)
def flash_attention_grad_op(ctx, q, k, v, bias_qk, mask, out, seed_words,
                            lse, dy, causal=False, scale=0.0, layout="BHSD",
                            dropout_prob=0.0, is_test=False):
    """dQ, dK, dV on the forward's route: the small-sequence backward
    kernels from the saved Seed (read on the card) and Lse; the composed
    route's replay with the saved Mask; or the flash backward kernels,
    after running the forward kernel again for the out/lse pair (the
    forward's Lse output is the reference's placeholder there), as the
    reference's ``jax.vjp`` replays the forward."""
    _check_layout(layout)
    if dy is None:
        return None, None, None
    sm_scale = scale if scale else q.shape[-1] ** -0.5
    attrs = {"dropout_prob": dropout_prob, "is_test": is_test,
             "causal": causal, "layout": layout}
    if _fa_small_route(q, k, bias_qk, attrs):
        grads = small_attention_bwd(q, k, v, bias_qk, sm_scale, dropout_prob,
                                    seed_words, out, lse, dy)
    elif _uses_dropout(attrs):
        grads = _composed_grad(q, k, v, bias_qk, mask, dy, causal, sm_scale,
                               1.0 - dropout_prob)
    else:
        out2, lse2 = flash_attention(q, k, v, bias=bias_qk, causal=causal,
                                     sm_scale=sm_scale)
        grads = flash_attention_bwd(q, k, v, bias_qk, out2, lse2, dy, causal,
                                    sm_scale)
    return tuple(g if wants_grad(ctx, s) else None
                 for g, s in zip(grads, "QKV"))


# -- fused_dropout_add_ln ----------------------------------------------------


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


_FDALN_ATTRS = {"dropout_prob": 0.0, "is_test": False, "epsilon": 1e-5,
                "begin_norm_axis": 1, "fix_seed": False, "seed": 0}


@register_op("fused_dropout_add_ln", inputs=("X", "Y", "Scale", "Bias"),
             outputs=("Out", "R", "Mean", "Variance", "Seed"),
             attrs=_FDALN_ATTRS, grad_maker=_fused_dropout_add_ln_grad_maker,
             n_rng=1)
def fused_dropout_add_ln_op(ctx, x, y, scale, bias, dropout_prob=0.0,
                            is_test=False, epsilon=1e-5, begin_norm_axis=1,
                            fix_seed=False, seed=0, **_):
    """Out = LayerNorm(X + dropout(Y)) through the fused kernel.  Training
    (p > 0): the mask is drawn inside the kernel from the op's key words,
    which it stores to Seed for the grad op to replay; at inference
    (is_test, or p = 0) the dropout is the identity and Seed is zeros, as
    in the reference."""
    p = 0.0 if is_test else float(dropout_prob)
    if p > 0.0:
        seed_t = _seed_output(x.device)
        z, r, mean, var = fused_ln_fwd(x, y, scale, bias, p,
                                       _seed_words(ctx, fix_seed, seed),
                                       epsilon, begin_norm_axis,
                                       seed_out=seed_t)
        return z, r, mean, var, seed_t
    z, r, mean, var = fused_ln_fwd(x, y, scale, bias, 0.0, None, epsilon,
                                   begin_norm_axis)
    return z, r, mean, var, _placeholder((2,), torch.int32, x.device)


fused_dropout_add_ln_op.opdef.rng_when = _uses_dropout


@register_op("fused_dropout_add_ln_grad",
             inputs=("R", "Scale", "Seed", "Mean", "Variance", "GRAD@Out"),
             outputs=("X@X", "X@Y", "X@Scale", "X@Bias"),
             attrs=_FDALN_ATTRS, grad_maker=None)
def fused_dropout_add_ln_grad_op(ctx, r, scale, seed_words, mean, var, dz,
                                 dropout_prob=0.0, is_test=False,
                                 epsilon=1e-5, begin_norm_axis=1, **_):
    """dX, dY, dScale, dBias from the saved residual sum R, the row
    statistics and (p > 0) the Seed tensor, whose words the backward
    kernel reads on the card to re-draw the forward's mask."""
    p = 0.0 if is_test else float(dropout_prob)
    return fused_ln_bwd(r, scale, mean, var, dz, p,
                        seed_words if p > 0.0 else None, epsilon,
                        begin_norm_axis)
