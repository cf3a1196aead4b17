"""Conv, pooling, normalisation, dropout and attention ops and their
gradients: conv2d, pool2d, batch_norm, conv2d_bn_relu, layer_norm,
dropout, label_smooth, flash_attention, fused_dropout_add_ln.

Counterpart of ``paddle_tpu/ops/nn.py`` (``conv2d:42``, ``pool2d:175``,
``batch_norm:332`` with ``_bn_impl:254`` and its grad op ``:357``,
``conv2d_bn_relu:406``, ``layer_norm:460``, ``dropout:602`` and its grad
op ``:634``, ``label_smooth:649``, ``flash_attention:863`` and its grad
op ``:941``,
``fused_dropout_add_ln:1018`` and its grad op ``:1063``).

Conv and pooling are plain PyTorch (``F.conv2d``, cuDNN on the card with
TF32 off), as the reference leaves them to XLA; their grads are written
out (``convolution_backward``; pooling by autograd over its forward),
which costs a fraction of a ``torch.func.vjp`` replay's host time.
``batch_norm`` follows ``_bn_impl``: f32 statistics as E[x^2] - m^2, the
normalisation folded into one per-channel affine (``F.batch_norm``'s
variance algorithm differs).  ``conv2d_bn_relu`` takes the conv-block
kernels under ``FLAGS_use_pallas_conv_block`` where
``conv_block_ok`` holds, else the exact conv2d + ``_bn_impl`` (+ relu)
composition; its grad replays that composition under autograd on both
routes, as the reference's custom VJP does.

The other ops reach their kernel wrappers, which launch the CUDA kernel
on the card and run the plain version on the CPU.  The grads are
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
import torch.nn.functional as F

from .. import flags
from ..core.registry import (GradOpDesc, default_infer_shape, get_op_def,
                             lower_attrs, register_grad_lowering, register_op,
                             wants_grad)
from ..framework import _grad_var_name
from ..kernels import philox
from ..kernels.conv_block import (affine_act, bn_fold, conv_bn_act,
                                  conv_block_ok, conv_stats, fold_affine)
from ..kernels.dropout import dropout as dropout_kernel, true_divide
from ..kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                       small_attention_bwd,
                                       small_attention_fwd,
                                       small_attention_shapes_ok)
from ..kernels.fused_ln import fused_ln_bwd, fused_ln_fwd
from ..kernels.layer_norm import layer_norm_2d
from .common import byte_threshold, realized_keep_prob


# -- conv --------------------------------------------------------------------


def _check_nchw(data_format, op):
    if data_format not in ("NCHW", "AnyLayout"):
        raise NotImplementedError(
            "%s data_format %r: the port runs NCHW; channels-last is not "
            "ported yet (ROADMAP)" % (op, data_format))


def _conv_pads(x, w, strides, paddings, dilations, padding_algorithm):
    """[(top, bottom), (left, right)] of the reference's conv2d padding:
    EXPLICIT [ph, pw] or [top, bottom, left, right], VALID, or SAME as
    XLA pads it (the excess split low-first)."""
    if padding_algorithm == "VALID":
        return [(0, 0), (0, 0)]
    if padding_algorithm == "SAME":
        pads = []
        for i in (0, 1):
            n, k = x.shape[2 + i], w.shape[2 + i]
            s, d = int(strides[i]), int(dilations[i])
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    p = [int(v) for v in paddings]
    return [(p[0], p[0]), (p[1], p[1])] if len(p) == 2 \
        else [(p[0], p[1]), (p[2], p[3])]


def _padded(x, pads, value=0.0):
    """x with [(top, bottom), (left, right)] padding of ``value``."""
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b), value=value)


def _amp_conv(ctx, x):
    """Whether a conv over ``x`` takes bf16 operands (the AMP policy on,
    x f32 or bf16)."""
    return x.dtype in (torch.float32, torch.bfloat16) and ctx.amp_bf16()


_CONV_ATTRS = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
               "groups": 1, "data_format": "NCHW",
               "padding_algorithm": "EXPLICIT", "use_cudnn": True,
               "use_mkldnn": False, "fuse_relu_before_depthwise_conv": False,
               "workspace_size_MB": 512, "exhaustive_search": False}


@register_op("conv2d", inputs=("Input", "Filter"), outputs=("Output",),
             attrs=_CONV_ATTRS)
def conv2d(ctx, x, w, strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
           groups=1, data_format="NCHW", padding_algorithm="EXPLICIT", **_):
    """NCHW x, OIHW filters; asymmetric padding is applied before the
    conv.  Under the bf16 AMP policy both operands are bf16 and so is the
    result (cuDNN keeps f32 sums), as the reference's."""
    _check_nchw(data_format, "conv2d")
    if _amp_conv(ctx, x):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    pads = _conv_pads(x, w, strides, paddings, dilations, padding_algorithm)
    (t, b), (l, r) = pads
    if t == b and l == r:
        return F.conv2d(x, w, stride=tuple(strides), padding=(t, l),
                        dilation=tuple(dilations), groups=groups)
    return F.conv2d(_padded(x, pads), w, stride=tuple(strides),
                    dilation=tuple(dilations), groups=groups)


@register_grad_lowering("conv2d")
def conv2d_grad(ctx, x, w, out, dout, strides=(1, 1), paddings=(0, 0),
                dilations=(1, 1), groups=1, data_format="NCHW",
                padding_algorithm="EXPLICIT", **_):
    """dInput and dFilter in one ``convolution_backward`` (cuDNN on the
    card), only those the op writes."""
    want_x, want_w = wants_grad(ctx, "Input"), wants_grad(ctx, "Filter")
    if dout is None or not (want_x or want_w):
        return None, None
    xd, wd = x.dtype, w.dtype
    if _amp_conv(ctx, x):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    dout = dout.to(out.dtype)
    pads = _conv_pads(x, w, strides, paddings, dilations, padding_algorithm)
    (t, b), (l, r) = pads
    sym = t == b and l == r
    xin = x if sym else _padded(x, pads)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dout.contiguous(), xin, w, None, list(strides),
        [t, l] if sym else [0, 0], list(dilations), False, [0, 0], groups,
        [want_x, want_w, False])
    if dx is not None and not sym:
        dx = dx[:, :, t:t + x.shape[2], l:l + x.shape[3]]
    return (None if dx is None else dx.to(xd),
            None if dw is None else dw.to(wd))


# -- pooling -----------------------------------------------------------------

_POOL_ATTRS = {"pooling_type": "max", "ksize": [1, 1], "strides": [1, 1],
               "paddings": [0, 0], "global_pooling": False,
               "ceil_mode": False, "exclusive": True, "adaptive": False,
               "data_format": "NCHW", "padding_algorithm": "EXPLICIT",
               "use_cudnn": True}


@register_op("pool2d", inputs=("X",), outputs=("Out",), attrs=_POOL_ATTRS)
def pool2d(ctx, x, pooling_type="max", ksize=(1, 1), strides=(1, 1),
           paddings=(0, 0), global_pooling=False, ceil_mode=False,
           exclusive=True, adaptive=False, data_format="NCHW", **_):
    """The reference's windows exactly: max pads with -inf and avg with 0,
    ceil_mode extends the END padding so a window may start in it
    (``F.max_pool2d(ceil_mode=True)`` would drop that window), exclusive
    avg divides by the in-bounds cells, adaptive bins start at
    floor(i I / O) and end at ceil((i + 1) I / O)."""
    _check_nchw(data_format, "pool2d")
    is_max = pooling_type == "max"
    if global_pooling:
        return x.amax(dim=(2, 3), keepdim=True) if is_max \
            else x.mean(dim=(2, 3), keepdim=True)
    if adaptive:
        size = (int(ksize[0]), int(ksize[1]))
        return F.adaptive_max_pool2d(x, size) if is_max \
            else F.adaptive_avg_pool2d(x, size)
    (kh, kw), (sh, sw), pads = _pool_windows(x, ksize, strides, paddings,
                                             ceil_mode)
    if is_max:
        return F.max_pool2d(_max_padded(x, pads), (kh, kw), (sh, sw))
    total = F.avg_pool2d(_padded(x, pads), (kh, kw), (sh, sw),
                         divisor_override=1)
    if exclusive and pads != [(0, 0), (0, 0)]:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return total / F.avg_pool2d(_padded(ones, pads), (kh, kw), (sh, sw),
                                    divisor_override=1)
    return total / (kh * kw)


def _pool_windows(x, ksize, strides, paddings, ceil_mode):
    """((kh, kw), (sh, sw), [(top, bottom), (left, right)] padding) of a
    pool2d window over ``x``; ceil_mode extends the END padding."""
    kh, kw = int(ksize[0]), int(ksize[1])
    sh, sw = int(strides[0]), int(strides[1])
    ph, pw = int(paddings[0]), int(paddings[1])
    eh = -(x.shape[2] + 2 * ph - kh) % sh if ceil_mode else 0
    ew = -(x.shape[3] + 2 * pw - kw) % sw if ceil_mode else 0
    return (kh, kw), (sh, sw), [(ph, ph + eh), (pw, pw + ew)]


def _max_padded(x, pads):
    low = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    return _padded(x, pads, low)


def _max_pool2d_grad_in_order(x, dout, ksize=(1, 1), strides=(1, 1),
                              paddings=(0, 0), ceil_mode=False, **_):
    """dX of a max pool2d whose windows overlap: each element adds the
    grads of the windows whose first maximum it is one at a time, in the
    windows' row-major order, in dout's dtype (one rounding an add), on
    any device.  For each element, a = 0 .. ceil(kh / sh) - 1 walks its
    candidate window rows and b its columns, so (a, b) in turn is the
    row-major order."""
    (kh, kw), (sh, sw), pads = _pool_windows(x, ksize, strides, paddings,
                                             ceil_mode)
    xp = _max_padded(x, pads)
    _, idx = F.max_pool2d(xp, (kh, kw), (sh, sw), return_indices=True)
    n_oh, n_ow = idx.shape[2:]
    h = torch.arange(x.shape[2], device=x.device) + pads[0][0]
    w = torch.arange(x.shape[3], device=x.device) + pads[1][0]
    target = h[:, None] * xp.shape[3] + w[None, :]
    first_h = ((h - kh + 1).clamp(min=0) + sh - 1) // sh
    first_w = ((w - kw + 1).clamp(min=0) + sw - 1) // sw
    dx = dout.new_zeros(x.shape)
    for a in range(-(-kh // sh)):
        oh = first_h + a
        ok_h = (oh * sh <= h) & (oh < n_oh)
        rows = oh.clamp(max=n_oh - 1)[:, None]
        for b in range(-(-kw // sw)):
            ow = first_w + b
            ok = ok_h[:, None] & ((ow * sw <= w) & (ow < n_ow))[None, :]
            cols = ow.clamp(max=n_ow - 1)[None, :]
            hit = (idx[:, :, rows, cols] == target) & ok
            dx = dx + torch.where(hit, dout[:, :, rows, cols], 0)
    return dx


@register_grad_lowering("pool2d")
def pool2d_grad(ctx, x, out, dout, **attrs):
    """dX by autograd over the forward (max routes each window's gradient
    to its first maximum, as XLA's select-and-scatter does).  A bf16 max
    pool whose windows overlap takes ``_max_pool2d_grad_in_order``: the
    reference and the CPU's autograd round after each of an element's
    adds, the card's autograd sums in f32 and rounds once (1 ulp apart at
    0.5% of a ResNet stem's elements)."""
    if dout is None or not wants_grad(ctx, "X"):
        return (None,)
    dout = dout.to(out.dtype)
    a = dict(_POOL_ATTRS, **attrs)
    if x.dtype == torch.bfloat16 and a["pooling_type"] == "max" \
            and not (a["global_pooling"] or a["adaptive"]) \
            and (int(a["ksize"][0]) > int(a["strides"][0])
                 or int(a["ksize"][1]) > int(a["strides"][1])):
        _check_nchw(a["data_format"], "pool2d")
        return (_max_pool2d_grad_in_order(x, dout, **a),)
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        return torch.autograd.grad(pool2d(ctx, xg, **attrs), xg, dout)


# -- batch norm --------------------------------------------------------------


def _bn_axes(x, data_layout):
    """(reduced axes, per-channel shape) of a batch norm over ``x``."""
    c_ax = 1 if data_layout in ("NCHW", "AnyLayout") else x.dim() - 1
    cshape = [1] * x.dim()
    cshape[c_ax] = x.shape[c_ax]
    return tuple(i for i in range(x.dim()) if i != c_ax), cshape


def _bn_impl(x, scale, bias, mean, variance, axes, cshape, momentum,
             epsilon, use_stored_stats):
    """The reference's ``_bn_impl``: f32 statistics (E[x^2] - m^2), the
    running ones blended as momentum old + (1 - momentum) batch, and the
    normalisation folded into one per-channel affine.  -> (y, MeanOut,
    VarianceOut, SavedMean, SavedVariance = the inverse std)."""
    if use_stored_stats:
        m, v = mean, variance
        new_mean, new_var = mean, variance
    else:
        xs = x.float()
        m = xs.mean(dim=axes)
        v = (xs * xs).mean(dim=axes) - m * m
        new_mean = momentum * mean + (1 - momentum) * m
        new_var = momentum * variance + (1 - momentum) * v
    inv = 1.0 / torch.sqrt(v + epsilon)
    a = (inv * scale).reshape(cshape)
    b = (bias - m * inv * scale).reshape(cshape)
    return (x * a.to(x.dtype) + b.to(x.dtype), new_mean, new_var, m, inv)


def _bn_grad_maker(op, no_grad_set):
    """batch_norm_grad over Y only (the running statistics are
    stop-gradient), from SavedMean and SavedVariance."""
    inputs = {"X": list(op.input("X")), "Scale": list(op.input("Scale")),
              "Bias": list(op.input("Bias")),
              "SavedMean": list(op.output("SavedMean")),
              "SavedVariance": list(op.output("SavedVariance")),
              "GRAD@Y": [_grad_var_name(op.output("Y")[0])]}
    outputs = {}
    for slot in ("X", "Scale", "Bias"):
        n = op.input(slot)[0]
        if n not in no_grad_set:
            outputs["X@" + slot] = [_grad_var_name(n)]
    if not outputs:
        return []
    return [GradOpDesc("batch_norm_grad", inputs, outputs, dict(op.attrs))]


_BN_ATTRS = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": "NCHW", "use_global_stats": False,
             "trainable_statistics": False, "fuse_with_relu": False,
             "stat_subsample": 1}


@register_op("batch_norm", inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance", "ReserveSpace"),
             attrs=_BN_ATTRS, grad_maker=_bn_grad_maker)
def batch_norm(ctx, x, scale, bias, mean, variance, momentum=0.9,
               epsilon=1e-5, is_test=False, data_layout="NCHW",
               use_global_stats=False, stat_subsample=1, **_):
    if int(stat_subsample) != 1:
        raise NotImplementedError(
            "batch_norm stat_subsample %s (ghost batch statistics) is not "
            "ported yet" % (stat_subsample,))
    axes, cshape = _bn_axes(x, data_layout)
    return _bn_impl(x, scale, bias, mean, variance, axes, cshape, momentum,
                    epsilon, is_test or use_global_stats) + (None,)


@register_op("batch_norm_grad",
             inputs=("X", "Scale", "Bias", "SavedMean", "SavedVariance",
                     "GRAD@Y"),
             outputs=("X@X", "X@Scale", "X@Bias"),
             attrs={"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                    "data_layout": "NCHW", "use_global_stats": False},
             grad_maker=None, optional_inputs=("GRAD@Y",))
def batch_norm_grad(ctx, x, scale, bias, saved_mean, saved_inv_std, dy,
                    momentum=0.9, epsilon=1e-5, is_test=False,
                    data_layout="NCHW", use_global_stats=False, **_):
    """The reference's batch_norm_grad: f32 sums, dX as one per-channel
    affine a1 dY + a2 X + a3 of the training statistics (a1 dY alone with
    the stored ones)."""
    axes, cshape = _bn_axes(x, data_layout)
    if dy is None:
        dy = torch.zeros_like(x)
    n = 1
    for i in axes:
        n *= x.shape[i]
    mu = saved_mean.reshape(cshape).float()
    inv = saved_inv_std.reshape(cshape).float()
    dyf = dy.float()
    dscale = (dyf * ((x.float() - mu) * inv)).sum(dim=axes)
    dbias = dyf.sum(dim=axes)
    sinv = scale.float().reshape(cshape) * inv
    if is_test or use_global_stats:
        dx = dy * sinv.to(x.dtype)
    else:
        a2 = -sinv * inv * dscale.reshape(cshape) / n
        a3 = (-sinv * dbias.reshape(cshape)
              + sinv * inv * dscale.reshape(cshape) * mu) / n
        dx = dy * sinv.to(x.dtype) + x * a2.to(x.dtype) + a3.to(x.dtype)
    return (dx if wants_grad(ctx, "X") else None,
            dscale.to(scale.dtype) if wants_grad(ctx, "Scale") else None,
            dbias.to(scale.dtype) if wants_grad(ctx, "Bias") else None)


# -- conv2d_bn_relu ----------------------------------------------------------

_CBR_ATTRS = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
              "groups": 1, "data_format": "NCHW", "momentum": 0.9,
              "epsilon": 1e-5, "is_test": False, "with_relu": True}


def _conv_bn_composed(ctx, x, w, scale, bias, mean, variance, strides,
                      paddings, dilations, groups, data_format, momentum,
                      epsilon, is_test, with_relu):
    """The exact conv2d + ``_bn_impl`` (+ relu) composition."""
    conv = conv2d(ctx, x, w, strides, paddings, dilations, groups,
                  data_format)
    axes, cshape = _bn_axes(conv, data_format)
    y, new_mean, new_var, m, inv = _bn_impl(
        conv, scale, bias, mean, variance, axes, cshape, momentum, epsilon,
        is_test)
    return (torch.relu(y) if with_relu else y), new_mean, new_var, m, inv


@register_op("conv2d_bn_relu",
             inputs=("Input", "Filter", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Output", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             attrs=_CBR_ATTRS, no_grad_inputs=("Mean", "Variance"))
def conv2d_bn_relu(ctx, x, w, scale, bias, mean, variance, strides=(1, 1),
                   paddings=(0, 0), dilations=(1, 1), groups=1,
                   data_format="NCHW", momentum=0.9, epsilon=1e-5,
                   is_test=False, with_relu=True, **_):
    """Conv + batch norm (+ relu) in one op; SavedVariance holds the
    inverse std, as batch_norm's does.  Kernel route (the flag on and
    ``conv_block_ok``): inference folds the running statistics into (a,
    b) for one pass (row 11); training runs the conv with its channel
    partials (row 12), folds the batch statistics v = E[x^2] - m^2 into
    (a, b) and the op's statistics outputs (``bn_fold``, one launch), then
    the affine + relu pass (row 13)."""
    if not (flags.flag("FLAGS_use_pallas_conv_block") and conv_block_ok(
            tuple(x.shape), tuple(w.shape), strides, paddings, dilations,
            groups, data_format)):
        return _conv_bn_composed(ctx, x, w, scale, bias, mean, variance,
                                 strides, paddings, dilations, groups,
                                 data_format, momentum, epsilon, is_test,
                                 with_relu)
    stride, pad = int(strides[0]), int(paddings[0])
    if is_test:
        a, b = fold_affine(scale, bias, mean, variance, epsilon)
        y = conv_bn_act(x, w, a, b, stride, pad, bool(with_relu))
        v = variance.float()
        return y, mean, variance, mean.float(), 1.0 / torch.sqrt(v + epsilon)
    conv, s, ss = conv_stats(x, w, stride, pad)
    cnt = conv.shape[0] * conv.shape[2] * conv.shape[3]
    a, b, new_mean, new_var, m, inv = bn_fold(s, ss, scale, bias, mean,
                                              variance, cnt, momentum,
                                              epsilon)
    return (affine_act(conv, a, b, bool(with_relu)), new_mean, new_var, m,
            inv)


@register_grad_lowering("conv2d_bn_relu")
def conv2d_bn_relu_grad(ctx, x, w, scale, bias, mean, variance, y, dy,
                        mean_out, dmean_out, var_out, dvar_out, saved_mean,
                        dsaved_mean, saved_var, dsaved_var, **attrs):
    """dInput, dFilter, dScale, dBias: the composition replayed under
    autograd on either route (a ctypes kernel cannot be replayed; the
    reference's kernel route differentiates the same composition,
    ``conv_block.py:335``).  The statistics outputs are stop-gradient."""
    if any(g is not None for g in (dmean_out, dvar_out, dsaved_mean,
                                   dsaved_var)):
        raise NotImplementedError(
            "conv2d_bn_relu_grad through its statistics outputs")
    slots = ("Input", "Filter", "Scale", "Bias")
    want = [wants_grad(ctx, s) for s in slots]
    if dy is None or not any(want):
        return (None,) * 6
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(k)
                  for t, k in zip((x, w, scale, bias), want)]
        out = _conv_bn_composed(
            ctx, *leaves, mean, variance, attrs.get("strides", (1, 1)),
            attrs.get("paddings", (0, 0)), attrs.get("dilations", (1, 1)),
            attrs.get("groups", 1), attrs.get("data_format", "NCHW"),
            attrs.get("momentum", 0.9), attrs.get("epsilon", 1e-5),
            attrs.get("is_test", False), attrs.get("with_relu", True))[0]
        grads = iter(torch.autograd.grad(
            out, [t for t, k in zip(leaves, want) if k], dy))
    return tuple(next(grads) if k else None for k in want) + (None, None)


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
    Variance are stop-gradient outputs: no gradient flows into them.  A
    bf16 X's statistics come out of the forward rounded to bf16, which
    the reference's replay never uses: they are recomputed from X in f32
    here, as that replay does.  dY is taken in Y's dtype first, as the
    replay's cotangent."""
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
    if mean.dtype != torch.float32:
        mean = x2.mean(dim=1)
        var = ((x2 - mean[:, None]) ** 2).mean(dim=1)
    rstd = torch.rsqrt(var.reshape(-1, 1).float() + epsilon)
    xhat = (x2 - mean.reshape(-1, 1).float()) * rstd
    d = dy.to(y.dtype).reshape(-1, cols).float()
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


# -- label_smooth ------------------------------------------------------------


@register_op("label_smooth", inputs=("X", "PriorDist"), outputs=("Out",),
             attrs={"epsilon": 0.1}, optional_inputs=("PriorDist",))
def label_smooth(ctx, x, prior, epsilon=0.1):
    """(1 - epsilon) x + epsilon u, u the PriorDist over the last dim, or
    uniform 1 / depth without one."""
    k = x.shape[-1]
    if prior is not None:
        return (1.0 - epsilon) * x + epsilon * prior.reshape(
            (1,) * (x.dim() - 1) + (k,))
    return (1.0 - epsilon) * x + epsilon / k


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


def _flash_attention_infer(op, block):
    """The default inference, but for Lse on the flash route (dropout
    off): the lowering carries the real lse [B, H, Sq, 1] there, while the
    reference's desc records its [1, 1, 1, 1] placeholder; the desc keeps
    the reference's, so the port's programs stay equal to it."""
    default_infer_shape(get_op_def("flash_attention"), op, block)
    if not _uses_dropout(lower_attrs(op.attrs)) and op.output("Lse"):
        block.var(op.output("Lse")[0]).shape = (1, 1, 1, 1)


@register_op("flash_attention", inputs=("Q", "K", "V", "BiasQK"),
             outputs=("Out", "Mask", "Seed", "Lse"), attrs=_FA_ATTRS,
             optional_inputs=("BiasQK",), no_grad_inputs=("BiasQK",),
             grad_maker=_flash_attention_grad_maker, n_rng=1,
             infer_shape=_flash_attention_infer)
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
    * flash attention without dropout; Lse is the forward kernel's row
      log-sum-exp [B, H, Sq, 1], which the grad reads with Out (the
      reference returns a placeholder there and replays the forward);
      Mask and Seed are the reference's placeholders."""
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
    if _uses_dropout(attrs):
        keep_prob = 1.0 - dropout_prob
        p = _composed_probs(q, k, bias_qk, causal, sm_scale)
        pd, mask = dropout_kernel(p, ctx.seed_words(),
                                  byte_threshold(keep_prob),
                                  realized_keep_prob(keep_prob), True)
        return (torch.einsum("bhqk,bhkd->bhqd", pd, v), mask, seed_ph,
                _placeholder((1, 1, 1, 1), torch.float32, dev))
    out, lse = flash_attention(q, k, v, bias=bias_qk, causal=causal,
                               sm_scale=sm_scale)
    return out, _placeholder((1,), torch.uint8, dev), seed_ph, lse


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
    route's replay with the saved Mask; or the fused flash backward
    kernel from the saved Out and Lse (the reference's ``jax.vjp``
    replays the forward there instead)."""
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
        grads = flash_attention_bwd(q, k, v, bias_qk, out, lse, dy, causal,
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
    # the epilogue computes in X's dtype: a bf16 Y (an AMP product's)
    # is cast to the f32 residual's first, as the reference's
    y = y.to(x.dtype)
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
