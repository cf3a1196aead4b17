"""Fused dropout + residual add + LayerNorm forward: the plain PyTorch
version and the CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/fused_ln.py``
(``fused_ln_fwd:336``, ``_fwd_pallas:160`` / ``_fwd_kernel:106``):
z = LayerNorm(x + dropout(y)) * gamma + beta over the trailing dims from
``begin_norm_axis``, emitting z, the residual sum r (the only large
tensor the backward reads) and f32 row statistics.  Statistics are f32
whatever the carry dtype, and the variance is the mean of the centred
square, as in the reference.

Dropout with probability > 0 is the training path; its Philox stream
(the reference's ``prng.py``) comes with the training slice, so
``dropout_prob > 0`` raises on every device.

* ``fused_ln_reference``: the plain version.
* ``fused_ln_fwd``: CPU and meta tensors take the plain version; CUDA
  tensors launch ``csrc/fused_ln.cu`` or raise.
  ``fused_ln_fwd.launches`` counts kernel launches.
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["ln_stat_shapes", "fused_ln_reference", "fused_ln_fwd"]


def ln_stat_shapes(x_shape, begin_norm_axis):
    """(rows, norm_size) split of a shape at ``begin_norm_axis``."""
    n = 1
    for d in x_shape[:begin_norm_axis]:
        n *= int(d)
    h = 1
    for d in x_shape[begin_norm_axis:]:
        h *= int(d)
    return n, h


def _no_dropout(dropout_prob):
    if float(dropout_prob) > 0.0:
        raise NotImplementedError(
            "fused_ln_fwd with dropout_prob > 0 is the training path; its "
            "in-kernel dropout comes with the training slice")


def fused_ln_reference(x2, y2, gamma, beta, epsilon=1e-5):
    """Plain version over [N, h] rows -> (z, r in x's dtype, mean [N],
    var [N] float32)."""
    r = x2.float() + y2.float()
    mean = r.mean(dim=1, keepdim=True)
    c = r - mean
    var = (c * c).mean(dim=1, keepdim=True)
    z = c * torch.rsqrt(var + epsilon) * gamma.float() + beta.float()
    return (z.to(x2.dtype), r.to(x2.dtype), mean.reshape(-1),
            var.reshape(-1))


_VP, _I = ctypes.c_void_p, ctypes.c_int


def _kernel():
    return _build.function("fused_ln", "fused_ln_fwd_f32",
                           [_VP] * 8 + [_I, _I, ctypes.c_float, _VP])


def _fused_ln_cuda(x2, y2, gamma, beta, epsilon):
    fn = _kernel()
    check_cuda_f32("fused_ln", x2.device, x=x2, y=y2, gamma=gamma,
                   beta=beta)
    n, h = x2.shape
    if tuple(y2.shape) != (n, h) or gamma.numel() != h \
            or beta.numel() != h or n <= 0 or h <= 0:
        raise ValueError("fused_ln kernel: x %s, y %s, gamma %s, beta %s"
                         % (tuple(x2.shape), tuple(y2.shape),
                            tuple(gamma.shape), tuple(beta.shape)))
    z = torch.empty_like(x2)
    r = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    var = torch.empty(n, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = fn(x2.data_ptr(), y2.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), z.data_ptr(), r.data_ptr(), mean.data_ptr(),
             var.data_ptr(), n, h, float(epsilon), stream)
    raise_on_error("fused_ln", err)
    fused_ln_fwd.launches += 1
    return z, r, mean, var


def fused_ln_fwd(x, y, gamma, beta, dropout_prob=0.0, seed=None,
                 epsilon=1e-5, begin_norm_axis=None):
    """-> (z, r, mean [N], var [N]), z and r shaped like x, the
    statistics float32 over the N = prod(x.shape[:begin_norm_axis]) rows
    (default: normalise the last dim).  ``seed`` is the reference's
    dropout seed pair, unused while dropout is not ported."""
    _no_dropout(dropout_prob)
    if begin_norm_axis is None:
        begin_norm_axis = x.dim() - 1
    n, h = ln_stat_shapes(x.shape, begin_norm_axis)
    # y is carried in x's dtype, as the reference does
    x2 = x.reshape(n, h)
    y2 = y.to(x.dtype).reshape(n, h)
    g, b = gamma.reshape(h), beta.reshape(h)
    if x.device.type in ("cpu", "meta"):
        z, r, mean, var = fused_ln_reference(x2, y2, g, b, epsilon)
    else:
        z, r, mean, var = _fused_ln_cuda(x2.contiguous(), y2.contiguous(),
                                         g.contiguous(), b.contiguous(),
                                         epsilon)
    return z.reshape(x.shape), r.reshape(x.shape), mean, var


fused_ln_fwd.launches = 0
