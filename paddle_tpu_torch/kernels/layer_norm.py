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
* ``layer_norm_2d``: CPU and meta tensors take the plain version; CUDA
  tensors launch ``csrc/layer_norm.cu`` (x f32 or bf16, gamma and beta
  f32) or raise.  ``layer_norm_2d.launches`` counts kernel launches
  (``layer_norm_2d.launches_bf16`` those of the bf16 instantiation).
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda, check_cuda_f32, raise_on_error

__all__ = ["layer_norm_2d_reference", "layer_norm_2d"]


def layer_norm_2d_reference(x, g, b, eps=1e-5):
    """Plain version -> (y in x's dtype, mean [R] f32, var [R] f32)."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * g.float() + b.float()
    return y.to(x.dtype), mean.reshape(-1), var.reshape(-1)


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
