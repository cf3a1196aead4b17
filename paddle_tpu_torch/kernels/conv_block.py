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
  ``_affine_relu_kernel:155``): ``act(conv * a + b)``.

Each wrapper takes its plain version for CPU and meta tensors (the meta
run is the op's shape inference) and launches ``csrc/conv_block.cu`` for
CUDA tensors, raising on anything the kernel does not take; each counts
its launches in ``<wrapper>.launches`` (row 12's launch is the conv pass
and the in-order reduction of its partials, one count).  Everything is
NCHW float32.

``conv_block_checks`` is the reference's routing predicate without its
TPU-only checks (the backend, and the 12 MB VMEM plan cap, which a CUDA
kernel that tiles within an image does not have); the kernels take every
shape it accepts.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["conv_block_checks", "conv_block_ok", "out_size", "fold_affine",
           "conv_bn_act_reference", "conv_stats_reference",
           "affine_act_reference", "conv_bn_act", "conv_stats",
           "affine_act"]

# output pixels of one image per CTA of the conv kernel (csrc/conv_block.cu
# kTilePix): row 12's partials are [N, ceil(OH * OW / 64), C_out]
PIX_TILE = 64


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


def conv_bn_act(x, w, a, b, stride, pad, relu=True):
    """Row 11: act(conv(x, w) a + b) -> [N, C_out, OH, OW]."""
    if x.device.type in ("cpu", "meta"):
        return conv_bn_act_reference(x, w, a, b, stride, pad, relu)
    fn = _build.function("conv_block", "conv_bn_act_f32",
                         [_VP] * 5 + _SHAPE_ARGS + [_I, _VP])
    oh, ow = _check_conv("conv_bn_act", x, w, stride, pad)
    n, c, h, wd = x.shape
    co, k = w.shape[0], w.shape[2]
    _check_chan("conv_bn_act", x.device, co, a=a, b=b)
    out = torch.empty((n, co, oh, ow), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
             out.data_ptr(), n, c, h, wd, co, k, stride, pad, oh, ow,
             int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("conv_bn_act", err)
    conv_bn_act.launches += 1
    return out


conv_bn_act.launches = 0


def conv_stats(x, w, stride, pad):
    """Row 12: (conv [N, C_out, OH, OW], s [N, C_out], ss [N, C_out])."""
    if x.device.type in ("cpu", "meta"):
        return conv_stats_reference(x, w, stride, pad)
    fn = _build.function("conv_block", "conv_stats_f32",
                         [_VP] * 6 + _SHAPE_ARGS + [_I, _VP])
    oh, ow = _check_conv("conv_stats", x, w, stride, pad)
    n, c, h, wd = x.shape
    co, k = w.shape[0], w.shape[2]
    tiles = -(-(oh * ow) // PIX_TILE)
    dev = x.device
    conv = torch.empty((n, co, oh, ow), dtype=x.dtype, device=dev)
    part = torch.empty(2 * n * tiles * co, dtype=torch.float32, device=dev)
    s = torch.empty((n, co), dtype=torch.float32, device=dev)
    ss = torch.empty((n, co), dtype=torch.float32, device=dev)
    err = fn(x.data_ptr(), w.data_ptr(), conv.data_ptr(), part.data_ptr(),
             s.data_ptr(), ss.data_ptr(), n, c, h, wd, co, k, stride, pad,
             oh, ow, tiles, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("conv_stats", err)
    conv_stats.launches += 1
    return conv, s, ss


conv_stats.launches = 0


def affine_act(conv, a, b, relu=True):
    """Row 13: act(conv a + b) over [N, C_out, OH, OW], a, b [C_out]."""
    if conv.device.type in ("cpu", "meta"):
        return affine_act_reference(conv, a, b, relu)
    fn = _build.function("conv_block", "affine_act_f32",
                         [_VP] * 4 + [_LL, _I, _I, _I, _VP])
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
