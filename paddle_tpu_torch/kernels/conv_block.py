"""The conv + batch-norm + relu block: routing predicate, plain PyTorch
versions and the CUDA kernels.

Counterpart of ``paddle_tpu/pallas_kernels/conv_block.py``:

* ``conv_bn_act`` (row 11, ``_infer_pallas:173`` / ``_infer_kernel:133``):
  ``act(conv(x, w) * a + b)`` with a, b folded from the running
  statistics by ``fold_affine`` (``_fold_affine:240``);
* ``conv_stats`` (row 12, ``_train_pallas:191`` /
  ``_train_conv_kernel:143``): the conv and its per-image, per-channel
  sum and sum of squares, [N, C_out] each;
* ``affine_act`` (row 13, ``_affine_pallas:211`` /
  ``_affine_relu_kernel:155``): ``act(conv * a + b)``;
* ``bn_fold``: between rows 12 and 13, the batch statistics of row 12's
  sums folded into row 13's (a, b), with the op's running statistics,
  SavedMean and SavedVariance (the jnp around the reference's Pallas
  calls, ``_train_fwd_impl:319`` and ``_fold_affine:240``, and its op's
  running-statistics update, ``ops/nn.py:438``).

Each wrapper takes its plain version for CPU and meta tensors (the meta
run is the op's shape inference) and launches ``csrc/conv_block.cu`` for
CUDA tensors, raising on anything the kernel does not take; each counts
its launches in ``<wrapper>.launches`` (one count a call: rows 11 and
12 may first reorder the weights for the tap-major loader, and row 12
ends with the in-order reduction of its partials).  Everything is
NCHW float32.  The conv kernels compute in 3xTF32 on the tensor cores
(each f32 operand split into two TF32 parts, three products summed in
f32), which keeps f32 accuracy; their plain versions are f32 convs.

``conv_block_checks`` is the reference's routing predicate without its
TPU-only checks (the backend, and the 12 MB VMEM plan cap, which a CUDA
kernel that tiles the GEMM does not have); the kernels take every shape
it accepts.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["TILES", "LOADERS", "conv_tile", "stats_layout", "ctas_per_sm",
           "conv_block_checks", "conv_block_ok", "out_size", "fold_affine",
           "conv_bn_act_reference", "conv_stats_reference",
           "affine_act_reference", "bn_fold_reference", "conv_bn_act",
           "conv_stats", "affine_act", "bn_fold"]

# CTA tiles of the conv kernel, (C_out rows, pixels of the flattened
# N * OH * OW) each (csrc/conv_block.cu kTiles, in the same order)
TILES = ((64, 128), (64, 64))
# H100 SXM: 132 SMs; the wide tile wants four CTAs an SM (two resident at
# once, so two waves at least)
WIDE_MIN_CTAS = 4 * 132


def conv_tile(co, npix):
    """Index into TILES for a conv of ``co`` output channels over ``npix``
    output pixels (the batch's): 64 x 128 where its grid has at least
    WIDE_MIN_CTAS CTAs, else 64 x 64.  Over ResNet-50's 53 convs at batch
    32 on an H100 this is within 0.1% of the better of the two tiles for
    each conv; 128-channel tiles won only at the three stride-2 1x1
    shortcuts (by 4-17% there) and are not built (PERF.md, the sweeps of
    tools/torch_conv_bench.py)."""
    bm, bn = TILES[0]
    return 0 if -(-co // bm) * -(-npix // bn) >= WIDE_MIN_CTAS else 1


def stats_layout(n, p, bn):
    """(tiles, slots) of row 12's partials [tiles, slots, C_out] for n
    images of p output pixels in pixel tiles of bn: a tile's column sums
    go to slot (image - the tile's first image), and bn consecutive
    pixels touch at most ceil((bn - 1) / p) + 1 images."""
    tiles = -(-(n * p) // bn)
    return tiles, min(n, -(-(bn - 1) // p) + 1)


def out_size(h, k, s, p):
    return (h + 2 * p - k) // s + 1


def conv_block_checks(x_shape, w_shape, strides, paddings, dilations=(1, 1),
                      groups=1, data_format="NCHW"):
    """Ordered (reason, ok) pairs: the reference's ``conv_block_checks``
    (``conv_block.py:66``) without ``no_pallas``, ``backend`` and
    ``vmem``, and with a padding that is not negative."""
    sh, pd = tuple(strides), tuple(paddings)
    static = all(isinstance(d, int) and d >= 0
                 for d in tuple(x_shape) + tuple(w_shape))
    checks = [
        ("layout", data_format in ("NCHW", "AnyLayout")),
        ("symbolic_shape", static),
        ("rank", len(x_shape) == 4 and len(w_shape) == 4),
        ("groups", int(groups) == 1),
        ("dilation", tuple(dilations) in ((1, 1), ())),
        ("stride", len(sh) == 2 and sh[0] == sh[1] and sh[0] in (1, 2)),
        ("padding", len(pd) == 2 and pd[0] == pd[1] and pd[0] >= 0),
    ]
    if not (static and len(x_shape) == 4 and len(w_shape) == 4
            and len(sh) == 2 and len(pd) == 2):
        return checks
    _n, c, h, w = x_shape
    co, _ci, kh, kw = w_shape
    checks += [
        ("kernel_size", kh == kw and kh in (1, 3, 5, 7)),
        ("channels", c % 8 == 0 or c in (3, 4)),  # the stem takes RGB
        ("out_channels", co % 8 == 0),
    ]
    checks.append(("out_size", out_size(h, kh, sh[0], pd[0]) > 0
                   and out_size(w, kw, sh[0], pd[0]) > 0))
    return checks


def conv_block_ok(x_shape, w_shape, strides, paddings, dilations=(1, 1),
                  groups=1, data_format="NCHW"):
    return all(ok for _, ok in conv_block_checks(
        x_shape, w_shape, strides, paddings, dilations, groups, data_format))


def fold_affine(scale, bias, mean, var, eps):
    """(a, b) with a = scale / sqrt(var + eps), b = bias - mean a, in f32
    (``_fold_affine:240``)."""
    inv = 1.0 / torch.sqrt(var.float() + eps)
    a = inv * scale.float()
    return a, bias.float() - mean.float() * a


def _chan(t):
    return t.reshape(1, -1, 1, 1)


def conv_bn_act_reference(x, w, a, b, stride, pad, relu=True):
    y = F.conv2d(x, w, stride=stride, padding=pad) * _chan(a) + _chan(b)
    return torch.relu(y) if relu else y


def conv_stats_reference(x, w, stride, pad):
    """-> (conv, s, ss): s, ss [N, C_out] sum and sum of squares of each
    image's channel."""
    conv = F.conv2d(x, w, stride=stride, padding=pad)
    return conv, conv.sum(dim=(2, 3)), (conv * conv).sum(dim=(2, 3))


def affine_act_reference(conv, a, b, relu=True):
    y = conv * _chan(a) + _chan(b)
    return torch.relu(y) if relu else y


def _reciprocal(cnt):
    """1 / cnt rounded to f32: the fold divides by the count as PyTorch
    divides a CUDA tensor by a Python scalar, by a product with it."""
    return float(np.float32(1.0) / np.float32(cnt))


def bn_fold_reference(s, ss, scale, bias, mean, var, cnt, momentum, eps):
    """Plain version of the fold -> (a, b, MeanOut, VarianceOut, SavedMean,
    SavedVariance), each [C_out]: from row 12's sums s, ss [N, C_out] over
    ``cnt`` = N OH OW values a channel, m = sum_n s / cnt and v = sum_n ss
    / cnt - m^2 (the reference's formula, never a centred pass; the
    division a product with ``_reciprocal(cnt)``), a and b as
    ``fold_affine`` gives them, the running statistics momentum * old +
    (1 - momentum) * batch, and the inverse std 1 / sqrt(v + eps).  The
    images are added one after the other, in order, as the kernel adds
    them, and every step is one rounded f32 operation: the kernel is
    bitwise this."""
    sum_s, sum_ss = s[0].float(), ss[0].float()
    for i in range(1, s.shape[0]):
        sum_s = sum_s + s[i].float()
        sum_ss = sum_ss + ss[i].float()
    rcnt = _reciprocal(cnt)
    m = sum_s * rcnt
    v = sum_ss * rcnt - m * m
    a, b = fold_affine(scale, bias, m, v, eps)
    new_mean = momentum * mean + (1 - momentum) * m.to(mean.dtype)
    new_var = momentum * var + (1 - momentum) * v.to(var.dtype)
    return a, b, new_mean, new_var, m, 1.0 / torch.sqrt(v + eps)


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SHAPE_ARGS = [_I] * 10  # n, c, h, w, co, k, stride, pad, oh, ow


def _check_conv(kernel, x, w, stride, pad):
    """The kernels' contract: dense f32 NCHW x and square filters, shapes
    ``conv_block_ok`` accepts; -> (oh, ow)."""
    check_cuda_f32(kernel, x.device, x=x, w=w)
    if not conv_block_ok(tuple(x.shape), tuple(w.shape), (stride, stride),
                         (pad, pad)) or w.shape[1] != x.shape[1]:
        raise ValueError("%s kernel: x %s, w %s, stride %d, pad %d is not "
                         "a shape the kernel takes (conv_block_checks)"
                         % (kernel, tuple(x.shape), tuple(w.shape), stride,
                            pad))
    k = w.shape[2]
    return out_size(x.shape[2], k, stride, pad), \
        out_size(x.shape[3], k, stride, pad)


def _check_chan(kernel, dev, co, **vecs):
    check_cuda_f32(kernel, dev, **vecs)
    for name, t in vecs.items():
        if t.numel() != co:
            raise ValueError("%s kernel: %s has %d values for %d channels"
                             % (kernel, name, t.numel(), co))


def _pick_tile(kernel, tile, co, npix):
    if tile is None:
        return conv_tile(co, npix)
    if tile not in range(len(TILES)):
        raise ValueError("%s kernel: tile %r is not an index of TILES"
                         % (kernel, tile))
    return tile


# the conv kernel's input loaders (csrc/conv_block.cu kLoad)
LOADERS = ("gather", "1x1 16-byte", "tap-major")


def ctas_per_sm(tile, stats, load):
    """CTAs of one conv-kernel instantiation (TILES index, row 12 or 11,
    LOADERS index) an SM of the current card holds at once (the occupancy
    query); for reports."""
    fn = _build.function("conv_block", "conv_ctas_per_sm",
                         [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    raise_on_error("conv_ctas_per_sm", fn(tile, int(stats), load,
                                          ctypes.byref(out)))
    return out.value


def _tap_scratch(x, w):
    """The tap-major weights' scratch ([C_out, kh, kw, C], written by the
    kernel's entry) where the kernel reads x tap-major: C % 32 == 0 and a
    filter wider than 1x1."""
    if x.shape[1] % 32 == 0 and w.shape[2] > 1:
        return torch.empty_like(w)
    return None


def _ptr(t):
    return None if t is None else t.data_ptr()


def conv_bn_act(x, w, a, b, stride, pad, relu=True):
    """Row 11: act(conv(x, w) a + b) -> [N, C_out, OH, OW]."""
    return _conv_bn_act(x, w, a, b, stride, pad, relu, None)


def _conv_bn_act(x, w, a, b, stride, pad, relu, tile):
    """``conv_bn_act`` on the tile ``tile`` (an index of TILES; None:
    ``conv_tile``'s), so that a check or a sweep can reach every tile."""
    if x.device.type in ("cpu", "meta"):
        return conv_bn_act_reference(x, w, a, b, stride, pad, relu)
    fn = _build.function("conv_block", "conv_bn_act_f32",
                         [_VP] * 6 + _SHAPE_ARGS + [_I, _I, _VP])
    oh, ow = _check_conv("conv_bn_act", x, w, stride, pad)
    n, c, h, wd = x.shape
    co, k = w.shape[0], w.shape[2]
    _check_chan("conv_bn_act", x.device, co, a=a, b=b)
    tile = _pick_tile("conv_bn_act", tile, co, n * oh * ow)
    out = torch.empty((n, co, oh, ow), dtype=x.dtype, device=x.device)
    wtap = _tap_scratch(x, w)
    err = fn(x.data_ptr(), w.data_ptr(), _ptr(wtap), a.data_ptr(),
             b.data_ptr(), out.data_ptr(), n, c, h, wd, co, k, stride, pad,
             oh, ow, int(bool(relu)), tile,
             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("conv_bn_act", err)
    conv_bn_act.launches += 1
    return out


conv_bn_act.launches = 0


def conv_stats(x, w, stride, pad):
    """Row 12: (conv [N, C_out, OH, OW], s [N, C_out], ss [N, C_out])."""
    return _conv_stats(x, w, stride, pad, None)


def _conv_stats(x, w, stride, pad, tile):
    """``conv_stats`` on the tile ``tile``, as ``_conv_bn_act``."""
    if x.device.type in ("cpu", "meta"):
        return conv_stats_reference(x, w, stride, pad)
    fn = _build.function("conv_block", "conv_stats_f32",
                         [_VP] * 7 + _SHAPE_ARGS + [_I, _I, _I, _VP])
    oh, ow = _check_conv("conv_stats", x, w, stride, pad)
    n, c, h, wd = x.shape
    co, k = w.shape[0], w.shape[2]
    tile = _pick_tile("conv_stats", tile, co, n * oh * ow)
    tiles, slots = stats_layout(n, oh * ow, TILES[tile][1])
    dev = x.device
    conv = torch.empty((n, co, oh, ow), dtype=x.dtype, device=dev)
    part = torch.empty(2 * tiles * slots * co, dtype=torch.float32,
                       device=dev)
    s = torch.empty((n, co), dtype=torch.float32, device=dev)
    ss = torch.empty((n, co), dtype=torch.float32, device=dev)
    wtap = _tap_scratch(x, w)
    err = fn(x.data_ptr(), w.data_ptr(), _ptr(wtap), conv.data_ptr(),
             part.data_ptr(), s.data_ptr(), ss.data_ptr(), n, c, h, wd, co,
             k, stride, pad, oh, ow, tile, tiles, slots,
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("conv_stats", err)
    conv_stats.launches += 1
    return conv, s, ss


conv_stats.launches = 0


def _affine_kernel():
    return _build.function("conv_block", "affine_act_f32",
                           [_VP] * 4 + [_LL, _I, _I, _I, _VP])


def _fold_kernel():
    return _build.function("conv_block", "bn_fold_f32",
                           [_VP] * 7 + [_I, _I] + [ctypes.c_float] * 4
                           + [_VP])


def affine_act(conv, a, b, relu=True):
    """Row 13: act(conv a + b) over [N, C_out, OH, OW], a, b [C_out]."""
    if conv.device.type in ("cpu", "meta"):
        return affine_act_reference(conv, a, b, relu)
    fn = _affine_kernel()
    check_cuda_f32("affine_act", conv.device, conv=conv)
    if conv.dim() != 4 or conv.data_ptr() % 16:
        raise ValueError("affine_act kernel: conv %s must be a 16-byte "
                         "aligned [N, C, H, W] tensor" % (tuple(conv.shape),))
    n, co, oh, ow = conv.shape
    _check_chan("affine_act", conv.device, co, a=a, b=b)
    y = torch.empty_like(conv)
    err = fn(conv.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
             conv.numel(), co, oh * ow, int(bool(relu)),
             torch.cuda.current_stream(conv.device).cuda_stream)
    raise_on_error("affine_act", err)
    affine_act.launches += 1
    return y


affine_act.launches = 0


def bn_fold(s, ss, scale, bias, mean, var, cnt, momentum, eps):
    """The fold (``bn_fold_reference``'s six outputs, each [C_out]) in one
    launch on the card: s, ss [N, C_out] from ``conv_stats``; scale, bias,
    mean and var [C_out], all float32."""
    if s.device.type in ("cpu", "meta"):
        return bn_fold_reference(s, ss, scale, bias, mean, var, cnt,
                                 momentum, eps)
    fn = _fold_kernel()
    check_cuda_f32("bn_fold", s.device, s=s, ss=ss)
    if s.dim() != 2 or tuple(ss.shape) != tuple(s.shape) or s.numel() == 0:
        raise ValueError("bn_fold kernel: s %s, ss %s must be one [N, C] "
                         "shape" % (tuple(s.shape), tuple(ss.shape)))
    n, co = s.shape
    _check_chan("bn_fold", s.device, co, scale=scale, bias=bias, mean=mean,
                var=var)
    out = torch.empty((6, co), dtype=torch.float32, device=s.device)
    err = fn(s.data_ptr(), ss.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             mean.data_ptr(), var.data_ptr(), out.data_ptr(), n, co,
             _reciprocal(cnt), float(momentum), float(1 - momentum),
             float(eps),
             torch.cuda.current_stream(s.device).cuda_stream)
    raise_on_error("bn_fold", err)
    bn_fold.launches += 1
    return out.unbind(0)


bn_fold.launches = 0
