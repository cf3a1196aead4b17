"""LayerNorm forward over rows: the plain PyTorch version and the CUDA
kernel.

Counterpart of ``paddle_tpu/pallas_kernels/layer_norm.py``
(``layer_norm_2d:91``, ``_fwd_pallas:71`` / ``_ln_fwd_kernel:29``):
x [R, C], gamma/beta [C] -> (y [R, C], mean [R], var [R]) with f32
statistics.  The JAX package takes its kernel only under
``FLAGS_use_pallas_layer_norm``; the port's ``layer_norm`` op routes
through this one whenever Scale and Bias are present.

A bf16 x (the bf16 AMP policy's activations) with f32 gamma and beta
takes the kernel's bf16 instantiation: f32 statistics, y rounded once to
bf16, mean and var f32.

* ``layer_norm_2d_reference``: the plain version.
* ``layer_norm_2d_bf16_kernel_order``: the plain version of the bf16
  instantiation in the kernel's order of operations (the same lanes,
  folds, butterflies and fused multiply-adds, y rounded once to bf16), so
  the card's kernel can be held to one bf16 ulp of y even where y is the
  small difference of its two terms.
* ``layer_norm_2d``: CPU and meta tensors take the plain version; CUDA
  tensors launch ``csrc/layer_norm.cu`` (x f32 or bf16, gamma and beta
  f32) or raise.  ``layer_norm_2d.launches`` counts kernel launches
  (``layer_norm_2d.launches_bf16`` those of the bf16 instantiation).
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda, check_cuda_f32, raise_on_error

__all__ = ["layer_norm_2d_reference", "layer_norm_2d_bf16_kernel_order",
           "layer_norm_2d"]


def layer_norm_2d_reference(x, g, b, eps=1e-5):
    """Plain version -> (y in x's dtype, mean [R] f32, var [R] f32)."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * g.float() + b.float()
    return y.to(x.dtype), mean.reshape(-1), var.reshape(-1)


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product of two f32 is exact in
    f64), as the kernel's ``__fmaf_rn``."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(part):
    """[R, 32] lane partials -> [R], summed as the kernel's xor butterfly
    sums them (every lane ends with lane 0's value)."""
    lanes = torch.arange(32, device=part.device)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ off]
    return part[:, 0]


def _lanes(t, width):
    """[R, items * width] -> [R, n, 32, width]: element i of lane l is item
    l + 32 i of the row, zeros past its end; and the mask of real items."""
    r, items = t.shape[0], t.shape[1] // width
    n = -(-items // 32)
    pad = torch.zeros(r, 32 * n * width, dtype=t.dtype, device=t.device)
    pad[:, :items * width] = t
    valid = torch.zeros(32 * n * width, dtype=torch.bool, device=t.device)
    valid[:items * width] = True
    return pad.reshape(r, n, 32, width), valid.reshape(1, n, 32, width)


def bf16_vec_ok(x, g, b):
    """Whether ``layer_norm_fwd_bf16`` takes its 16-byte kernel for x
    (its test, but for y, whose fresh buffer is aligned)."""
    cols = x.shape[1]
    return cols % 8 == 0 and -(-(cols // 8) // 32) <= 4 and all(
        t.data_ptr() % 16 == 0 for t in (x, g, b))


def layer_norm_2d_bf16_kernel_order(x, g, b, eps=1e-5):
    """The bf16 instantiation's arithmetic, op for op, on x's device ->
    (y bf16, mean [R] f32, var [R] f32).  x bf16 [R, C], gamma and beta
    f32 [C].

    The 16-byte kernel (``bf16_vec_ok``): lane l holds the chunks
    l + 32 i of eight bf16 and adds them component-wise in i, folds the
    eight partials as ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), and the
    warp sums the lanes by an xor butterfly; the centred squares the same
    way by fused multiply-adds.  The scalar kernel: lane l adds columns
    l + 32 i in turn, then the butterfly.  Both: mean = sum * (1 / C),
    rstd = rsqrt(var + eps), y = bf16(fma((x - mean) * rstd, gamma,
    beta))."""
    rows, cols = x.shape
    inv_h = torch.tensor(1.0, dtype=torch.float32) / cols
    inv_h = inv_h.to(x.device)
    width = 8 if bf16_vec_ok(x, g, b) else 1
    xv, valid = _lanes(x.float(), width)
    gv, bv = (_lanes(t.float().reshape(1, cols), width)[0] for t in (g, b))

    def total(part):
        # [R, 32, width] -> [R]: the width-8 fold, then the butterfly
        if width == 8:
            p = [part[..., k] for k in range(8)]
            part = ((p[0] + p[1]) + (p[2] + p[3])) + \
                ((p[4] + p[5]) + (p[6] + p[7]))
        else:
            part = part[..., 0]
        return _butterfly(part)

    acc = torch.zeros(rows, 32, width, dtype=torch.float32, device=x.device)
    for i in range(xv.shape[1]):
        acc = acc + xv[:, i]
    mu = total(acc) * inv_h
    cen = torch.where(valid, xv - mu[:, None, None, None],
                      torch.zeros((), device=x.device))
    acc = torch.zeros_like(acc)
    for i in range(cen.shape[1]):
        acc = _fma(cen[:, i], cen[:, i], acc)
    var = total(acc) * inv_h
    rstd = torch.rsqrt(var + eps)
    y = _fma(cen * rstd[:, None, None, None], gv, bv)
    y = y.reshape(rows, -1)[:, :cols].to(torch.bfloat16)
    return y, mu, var


_VP, _I = ctypes.c_void_p, ctypes.c_int


_SYMBOLS = {torch.float32: "layer_norm_fwd_f32",
            torch.bfloat16: "layer_norm_fwd_bf16"}


def _kernel(dtype=torch.float32):
    return _build.function("layer_norm", _SYMBOLS[dtype],
                           [_VP] * 6 + [_I, _I, ctypes.c_float, _VP])


def _layer_norm_cuda(x, g, b, eps):
    fn = _kernel(x.dtype if x.dtype in _SYMBOLS else torch.float32)
    check_cuda("layer_norm", x.device, tuple(_SYMBOLS), x=x)
    check_cuda_f32("layer_norm", x.device, gamma=g, beta=b)
    if x.dim() != 2 or g.numel() != x.shape[1] or b.numel() != x.shape[1] \
            or x.numel() == 0:
        raise ValueError("layer_norm kernel: x %s, gamma %s, beta %s"
                         % (tuple(x.shape), tuple(g.shape), tuple(b.shape)))
    rows, cols = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    var = torch.empty(rows, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
             mean.data_ptr(), var.data_ptr(), rows, cols, float(eps),
             stream)
    raise_on_error("layer_norm", err)
    layer_norm_2d.launches += 1
    if x.dtype == torch.bfloat16:
        layer_norm_2d.launches_bf16 += 1
    return y, mean, var


def layer_norm_2d(x, g, b, eps=1e-5):
    """LN over the last dim of x [R, C] -> (y, mean [R], var [R])."""
    if x.device.type in ("cpu", "meta"):
        return layer_norm_2d_reference(x, g, b, eps)
    return _layer_norm_cuda(x.contiguous(), g.contiguous(), b.contiguous(),
                            eps)


layer_norm_2d.launches = 0
layer_norm_2d.launches_bf16 = 0
