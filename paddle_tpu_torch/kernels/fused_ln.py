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

Dropout (p > 0, upscale_in_train) keeps the reference's contract: keep
iff u32 < ``keep_threshold(p)``, kept values times ``inv_realized_q`` in
f32, y' = keep ? y * inv_q : 0 before the residual add and dy = keep ?
dr * inv_q : 0 in the backward.  The u32 of element ``row * h + col``
of the [N, h] view comes from the port's Philox stream (``philox.py``)
keyed by the op's two seed words: the forward takes them on the host
and stores them to ``seed_out`` (the op's Seed output; on the card the
kernel writes it), the backward re-draws the same mask from that Seed
tensor (on the card the kernel reads it, so the host never waits).

* ``fused_ln_reference`` / ``fused_ln_bwd_reference``: the plain
  versions.
* ``fused_ln_fwd`` / ``fused_ln_bwd``: CPU and meta tensors take the
  plain version; CUDA tensors launch ``csrc/fused_ln.cu`` /
  ``csrc/fused_ln_bwd.cu`` or raise.  ``fused_ln_fwd.launches`` and
  ``fused_ln_bwd.launches`` count kernel launches.
"""

import ctypes

import torch

from . import _build, philox
from ._checks import check_cuda_f32, check_seed_tensor, raise_on_error

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


def _dropped(v2, seed, thr):
    """keep ? v * inv_q : 0 of the [N, h] rows, the keep mask drawn from
    the stream keyed by ``seed`` (no data on the meta device)."""
    if thr is None or v2.device.type == "meta":
        return v2
    keep = philox.keep_mask(seed, thr, v2.shape, v2.device)
    return torch.where(keep, v2 * philox.inv_realized_q(thr),
                       torch.zeros((), dtype=v2.dtype, device=v2.device))


def fused_ln_reference(x2, y2, gamma, beta, epsilon=1e-5, dropout_prob=0.0,
                       seed=None):
    """Plain version over [N, h] rows -> (z, r in x's dtype, mean [N],
    var [N] float32); ``seed`` (two key words) is read at p > 0."""
    thr = philox.keep_threshold(dropout_prob)
    r = x2.float() + _dropped(y2.float(), seed, thr)
    mean = r.mean(dim=1, keepdim=True)
    c = r - mean
    var = (c * c).mean(dim=1, keepdim=True)
    z = c * torch.rsqrt(var + epsilon) * gamma.float() + beta.float()
    return (z.to(x2.dtype), r.to(x2.dtype), mean.reshape(-1),
            var.reshape(-1))


_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


def _kernel():
    return _build.function("fused_ln", "fused_ln_fwd_f32",
                           [_VP] * 8 + [_I, _I, ctypes.c_float, _U, _U, _U,
                                        ctypes.c_float, _VP, _VP])


def _fused_ln_cuda(x2, y2, gamma, beta, epsilon, dropout_prob=0.0,
                   seed=None, seed_out=None):
    fn = _kernel()
    check_cuda_f32("fused_ln", x2.device, x=x2, y=y2, gamma=gamma,
                   beta=beta)
    n, h = x2.shape
    if tuple(y2.shape) != (n, h) or gamma.numel() != h \
            or beta.numel() != h or n <= 0 or h <= 0:
        raise ValueError("fused_ln kernel: x %s, y %s, gamma %s, beta %s"
                         % (tuple(x2.shape), tuple(y2.shape),
                            tuple(gamma.shape), tuple(beta.shape)))
    if seed_out is not None:
        check_seed_tensor("fused_ln", "seed_out", seed_out, x2.device)
    thr = philox.keep_threshold(dropout_prob)
    k0, k1 = philox.seed_words(seed) if seed is not None else (0, 0)
    z = torch.empty_like(x2)
    r = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    var = torch.empty(n, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = fn(x2.data_ptr(), y2.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), z.data_ptr(), r.data_ptr(), mean.data_ptr(),
             var.data_ptr(), n, h, float(epsilon), thr or 0, k0, k1,
             philox.inv_realized_q(thr) if thr is not None else 1.0,
             seed_out.data_ptr() if seed_out is not None else None, stream)
    raise_on_error("fused_ln", err)
    fused_ln_fwd.launches += 1
    return z, r, mean, var


def fused_ln_fwd(x, y, gamma, beta, dropout_prob=0.0, seed=None,
                 epsilon=1e-5, begin_norm_axis=None, seed_out=None):
    """-> (z, r, mean [N], var [N]), z and r shaped like x, the
    statistics float32 over the N = prod(x.shape[:begin_norm_axis]) rows
    (default: normalise the last dim).  At ``dropout_prob`` > 0, ``seed``
    is the pair of key words (held on the host); ``seed_out``, an int32
    [2] tensor on x's device, receives them when given."""
    if begin_norm_axis is None:
        begin_norm_axis = x.dim() - 1
    n, h = ln_stat_shapes(x.shape, begin_norm_axis)
    # y is carried in x's dtype, as the reference does
    x2 = x.reshape(n, h)
    y2 = y.to(x.dtype).reshape(n, h)
    g, b = gamma.reshape(h), beta.reshape(h)
    if x.device.type in ("cpu", "meta"):
        z, r, mean, var = fused_ln_reference(x2, y2, g, b, epsilon,
                                             dropout_prob, seed)
        if seed_out is not None and x.device.type == "cpu":
            seed_out.copy_(philox.seed_tensor(
                seed if seed is not None else (0, 0)))
    else:
        z, r, mean, var = _fused_ln_cuda(x2.contiguous(), y2.contiguous(),
                                         g.contiguous(), b.contiguous(),
                                         epsilon, dropout_prob, seed,
                                         seed_out)
    return z.reshape(x.shape), r.reshape(x.shape), mean, var


fused_ln_fwd.launches = 0


def fused_ln_bwd_reference(r2, gamma, mean, var, dz2, epsilon=1e-5,
                           dropout_prob=0.0, seed=None):
    """Plain backward over [N, h] rows -> (dx, dy, dgamma, dbeta): at
    ``dropout_prob`` > 0 dy = keep ? dx * inv_q : 0, re-drawn from
    ``seed`` (two key words, or the forward's int32 Seed tensor, read on
    the host); at p = 0 dy is dx, one tensor."""
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
    thr = philox.keep_threshold(dropout_prob)
    dx = dr.to(r2.dtype)
    if thr is None:
        return dx, dx, dg, db
    if r2.device.type != "meta":
        seed = philox.seed_words(seed)
    return dx, _dropped(dr, seed, thr).to(r2.dtype), dg, db


# the kernel gives each CTA a run of rows, a multiple of its 4 warps;
# about four CTAs per SM of the card's 132 (its float4 kernel's
# occupancy) fill the card at BERT's 4096 rows: 512 CTAs of 8 rows there
# (256 CTAs of 16 rows timed 3% slower on an H100, PERF.md).
# The geometry depends on n alone, so the dgamma/dbeta partials, and the
# order they are added in, are the same on every run.
_BWD_WARPS = 4
_BWD_TARGET_CTAS = 528


def _bwd_grid(n):
    """(rows_per_cta, n_ctas) of the backward kernel for n rows."""
    per_warp = max(1, -(-n // (_BWD_WARPS * _BWD_TARGET_CTAS)))
    rows = _BWD_WARPS * per_warp
    return rows, -(-n // rows)


def _bwd_kernel():
    return _build.function("fused_ln_bwd", "fused_ln_bwd_f32",
                           [_VP] * 10 + [_I, _I, ctypes.c_float, _I, _I,
                                         _U, _VP, ctypes.c_float, _VP])


# the shared memory of a CTA holds 2 x 4 warps x h floats
_BWD_MAX_H = 7168


def _fused_ln_bwd_cuda(r2, gamma, mean, var, dz2, epsilon, dropout_prob=0.0,
                       seed=None):
    """-> (dx, dy, dgamma, dbeta), dy the same tensor as dx at p = 0.  At
    p > 0 ``seed`` is the forward's int32 [2] Seed tensor on the card:
    the kernel reads its words there."""
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
    thr = philox.keep_threshold(dropout_prob)
    if thr is not None:
        check_seed_tensor("fused_ln_bwd", "seed", seed, r2.device)
    rows, n_ctas = _bwd_grid(n)
    dx = torch.empty_like(r2)
    dy = torch.empty_like(r2) if thr is not None else None
    part = torch.empty((2, n_ctas, h), dtype=torch.float32, device=r2.device)
    dg = torch.empty(h, dtype=torch.float32, device=r2.device)
    db = torch.empty(h, dtype=torch.float32, device=r2.device)
    stream = torch.cuda.current_stream(r2.device).cuda_stream
    err = fn(r2.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
             var.data_ptr(), dz2.data_ptr(), dx.data_ptr(),
             dy.data_ptr() if dy is not None else None, part.data_ptr(),
             dg.data_ptr(), db.data_ptr(), n, h, float(epsilon), rows,
             n_ctas, thr or 0,
             seed.data_ptr() if thr is not None else None,
             philox.inv_realized_q(thr) if thr is not None else 1.0, stream)
    raise_on_error("fused_ln_bwd", err)
    fused_ln_bwd.launches += 1
    return dx, dx if dy is None else dy, dg, db


def fused_ln_bwd(r, gamma, mean, var, dz, dropout_prob=0.0, seed=None,
                 epsilon=1e-5, begin_norm_axis=None):
    """-> (dx, dy, dgamma, dbeta): dx and dy shaped like r (at dropout 0
    one tensor, since dy = dx there), dgamma and dbeta like gamma.  r,
    mean and var are the forward's outputs; at ``dropout_prob`` > 0
    ``seed`` is the forward's Seed tensor (on a CPU tensor's path also a
    pair of key words)."""
    if begin_norm_axis is None:
        begin_norm_axis = r.dim() - 1
    n, h = ln_stat_shapes(r.shape, begin_norm_axis)
    args = (r.reshape(n, h), gamma.reshape(h), mean.reshape(n).float(),
            var.reshape(n).float(), dz.to(r.dtype).reshape(n, h))
    if r.device.type in ("cpu", "meta"):
        dx, dy, dg, db = fused_ln_bwd_reference(*args, epsilon, dropout_prob,
                                                seed)
    else:
        dx, dy, dg, db = _fused_ln_bwd_cuda(
            *(a.contiguous() for a in args), epsilon, dropout_prob, seed)
    dx_out = dx.reshape(r.shape)
    dy_out = dx_out if dy is dx else dy.reshape(r.shape)
    return dx_out, dy_out, dg.to(gamma.dtype).reshape(gamma.shape), \
        db.to(gamma.dtype).reshape(gamma.shape)


fused_ln_bwd.launches = 0
