"""Fused dropout + residual add + LayerNorm, forward and backward: the
plain PyTorch versions and the CUDA kernels.

Counterpart of ``paddle_tpu/pallas_kernels/fused_ln.py``
(``fused_ln_fwd:336``, ``_fwd_pallas:160`` / ``_fwd_kernel:106``;
``fused_ln_bwd:356``, ``_bwd_pallas:186`` / ``_bwd_kernel:130``):
z = LayerNorm(x + dropout(y)) * gamma + beta over the trailing dims from
``begin_norm_axis``, emitting z, the residual sum r (the only large
tensor the backward reads) and f32 row statistics; the backward gives
dx, dy, dgamma and dbeta from r, the statistics and dz.  Statistics are
f32 whatever the carry dtype, and the variance is the mean of the
centred square, as in the reference.

Dropout with probability > 0 needs the reference's in-kernel random
stream (``prng.py``), which the port does not have yet (a Philox stream
comes with BERT at dropout 0.1), so ``dropout_prob > 0`` raises on every
device, forward and backward.

* ``fused_ln_reference`` / ``fused_ln_bwd_reference``: the plain
  versions.
* ``fused_ln_fwd`` / ``fused_ln_bwd``: CPU and meta tensors take the
  plain version; CUDA tensors launch ``csrc/fused_ln.cu`` /
  ``csrc/fused_ln_bwd.cu`` or raise.  ``fused_ln_fwd.launches`` and
  ``fused_ln_bwd.launches`` count kernel launches.
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["ln_stat_shapes", "fused_ln_reference", "fused_ln_fwd",
           "fused_ln_bwd_reference", "fused_ln_bwd"]


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
            "fused_ln with dropout_prob > 0 is the dropout training path; "
            "its in-kernel stream comes with BERT at dropout 0.1")


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


def fused_ln_bwd_reference(r2, gamma, mean, var, dz2, epsilon=1e-5):
    """Plain backward over [N, h] rows at dropout 0 -> (dx, dgamma, dbeta);
    dy equals dx there."""
    rf = r2.float()
    rstd = torch.rsqrt(var.reshape(-1, 1).float() + epsilon)
    xhat = (rf - mean.reshape(-1, 1).float()) * rstd
    dz = dz2.float()
    dg = (dz * xhat).sum(dim=0)
    db = dz.sum(dim=0)
    a = dz * gamma.float()
    m1 = a.mean(dim=1, keepdim=True)
    m2 = (a * xhat).mean(dim=1, keepdim=True)
    dr = rstd * (a - m1 - xhat * m2)
    return dr.to(r2.dtype), dg, db


# the kernel gives each CTA a run of rows; about two CTAs per SM of the
# card's 132 keep the dgamma/dbeta partials few
_BWD_WARPS = 4
_BWD_TARGET_CTAS = 264


def _bwd_grid(n):
    """(rows_per_cta, n_ctas) of the backward kernel for n rows."""
    per_warp = max(1, -(-n // (_BWD_WARPS * _BWD_TARGET_CTAS)))
    rows = _BWD_WARPS * per_warp
    return rows, -(-n // rows)


def _bwd_kernel():
    return _build.function("fused_ln_bwd", "fused_ln_bwd_f32",
                           [_VP] * 9 + [_I, _I, ctypes.c_float, _I, _I,
                                        _VP])


# the shared memory of a CTA holds 2 x 4 warps x h floats
_BWD_MAX_H = 7168


def _fused_ln_bwd_cuda(r2, gamma, mean, var, dz2, epsilon):
    fn = _bwd_kernel()
    check_cuda_f32("fused_ln_bwd", r2.device, r=r2, gamma=gamma, mean=mean,
                   var=var, dz=dz2)
    n, h = r2.shape
    if tuple(dz2.shape) != (n, h) or gamma.numel() != h \
            or mean.numel() != n or var.numel() != n or n <= 0 \
            or not 0 < h <= _BWD_MAX_H:
        raise ValueError("fused_ln_bwd kernel: r %s, dz %s, gamma %s, mean "
                         "%s, var %s (h <= %d)"
                         % (tuple(r2.shape), tuple(dz2.shape),
                            tuple(gamma.shape), tuple(mean.shape),
                            tuple(var.shape), _BWD_MAX_H))
    rows, n_ctas = _bwd_grid(n)
    dx = torch.empty_like(r2)
    part = torch.empty((2, n_ctas, h), dtype=torch.float32, device=r2.device)
    dg = torch.empty(h, dtype=torch.float32, device=r2.device)
    db = torch.empty(h, dtype=torch.float32, device=r2.device)
    stream = torch.cuda.current_stream(r2.device).cuda_stream
    err = fn(r2.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
             var.data_ptr(), dz2.data_ptr(), dx.data_ptr(), part.data_ptr(),
             dg.data_ptr(), db.data_ptr(), n, h, float(epsilon), rows,
             n_ctas, stream)
    raise_on_error("fused_ln_bwd", err)
    fused_ln_bwd.launches += 1
    return dx, dg, db


def fused_ln_bwd(r, gamma, mean, var, dz, dropout_prob=0.0, seed=None,
                 epsilon=1e-5, begin_norm_axis=None):
    """-> (dx, dy, dgamma, dbeta): dx and dy shaped like r (at dropout 0
    one tensor, since dy = dx there), dgamma and dbeta like gamma.  r,
    mean and var are the forward's outputs."""
    _no_dropout(dropout_prob)
    if begin_norm_axis is None:
        begin_norm_axis = r.dim() - 1
    n, h = ln_stat_shapes(r.shape, begin_norm_axis)
    args = (r.reshape(n, h), gamma.reshape(h), mean.reshape(n).float(),
            var.reshape(n).float(), dz.to(r.dtype).reshape(n, h))
    if r.device.type in ("cpu", "meta"):
        dx, dg, db = fused_ln_bwd_reference(*args, epsilon)
    else:
        dx, dg, db = _fused_ln_bwd_cuda(*(a.contiguous() for a in args),
                                        epsilon)
    dx = dx.reshape(r.shape)
    return dx, dx, dg.to(gamma.dtype).reshape(gamma.shape), \
        db.to(gamma.dtype).reshape(gamma.shape)


fused_ln_bwd.launches = 0
