"""Fused momentum step over a group of parameters: the plain PyTorch
version and the CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/fused_opt.py``
(``fused_momentum_step:186`` / ``_momentum_kernel:112``) and of the
``fused_momentum`` op's unfused path (``paddle_tpu/ops/optimizer_ops.py``
``fused_momentum:332``) without its l2_decay fold, which the op keeps on
the plain path as the reference does: per element of every member,

    v = mu v + g,   p = p - lr v   (Nesterov: p = p - (g + mu v) lr),

and an optional bf16 copy of the new p (the TPU kernel's carry output).

* ``fused_momentum_reference``: the plain version, one torch op per
  operation in f32 (mu as an f32 tensor, as the reference's weak-typed
  Python float); returns new tensors.
* ``fused_momentum_step``: CPU and meta tensors take the plain version;
  CUDA tensors launch ``csrc/fused_momentum.cu`` once for the whole
  group, which updates p and v IN PLACE and is bitwise equal to the plain
  version on the card.  ``fused_momentum_step.launches`` counts kernel
  launches.
"""

import ctypes

import numpy as np
import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error
from ._group import group_table

__all__ = ["fused_momentum_reference", "fused_momentum_step"]


def fused_momentum_reference(params, grads, vels, lr, mu=0.0,
                             use_nesterov=False, bf16_out=False):
    """-> (params, vels, bf16s or None), all new."""
    dev, dt = params[0].device, params[0].dtype
    mu_t = torch.tensor(mu, dtype=dt, device=dev)
    lr_ = lr.reshape(()).to(dt)
    ps, vs = [], []
    for p, g, v in zip(params, grads, vels):
        g = g.to(dt)
        vn = mu_t * v + g
        ps.append(p - (g + mu_t * vn) * lr_ if use_nesterov
                  else p - lr_ * vn)
        vs.append(vn)
    return ps, vs, ([p.to(torch.bfloat16) for p in ps] if bf16_out
                    else None)


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _kernel():
    return _build.function("fused_momentum", "fused_momentum_f32",
                           [_VP, _VP, _VP, _I, _LL, _F, _I, _VP])


def _check_members(params, vels, bf16s):
    dev = params[0].device
    n = len(params)
    if not n or len(vels) != n:
        raise ValueError("fused_momentum kernel: a group of %d params with "
                         "%d velocities" % (n, len(vels)))
    for i, (p, v) in enumerate(zip(params, vels)):
        check_cuda_f32("fused_momentum", dev, param=p, velocity=v)
        if p.shape != v.shape:
            raise ValueError("fused_momentum kernel: member %d: param %s, "
                             "velocity %s" % (i, tuple(p.shape),
                                              tuple(v.shape)))
    if bf16s is not None and (len(bf16s) != n or any(
            b.dtype != torch.bfloat16 or b.shape != p.shape
            or b.device != dev or not b.is_contiguous()
            for b, p in zip(bf16s, params))):
        raise ValueError("fused_momentum kernel: the bf16 buffers must be "
                         "dense bf16 tensors shaped like the params on %s"
                         % dev)


def _check_grads(params, grads, lr):
    """What changes from step to step: the grads (and the lr tensor)."""
    dev = params[0].device
    if len(grads) != len(params):
        raise ValueError("fused_momentum kernel: %d grads for %d params"
                         % (len(grads), len(params)))
    for i, (p, g) in enumerate(zip(params, grads)):
        check_cuda_f32("fused_momentum", dev, grad=g)
        if g.shape != p.shape:
            raise ValueError("fused_momentum kernel: grad %d is %s, param "
                             "%s" % (i, tuple(g.shape), tuple(p.shape)))
    check_cuda_f32("fused_momentum", dev, lr=lr)
    if lr.numel() != 1:
        raise ValueError("fused_momentum kernel: lr %s" % (tuple(lr.shape),))


def _fused_momentum_cuda(params, grads, vels, lr, mu, use_nesterov, bf16s):
    fn = _kernel()
    if params[0].device.type != "cuda":
        raise ValueError("fused_momentum kernel: tensors are on %s, not a "
                         "CUDA device" % params[0].device)
    _check_grads(params, grads, lr)
    dev = params[0].device
    # rows as csrc/fused_momentum.cu reads them: p, v, bf16 copy
    rows = [[t.data_ptr() for t in params], [t.data_ptr() for t in vels],
            [t.data_ptr() for t in bf16s] if bf16s else [0] * len(params)]
    table, total = group_table(rows, [p.numel() for p in params], dev,
                               lambda: _check_members(params, vels, bf16s))
    gptr = torch.tensor([g.data_ptr() for g in grads], dtype=torch.int64,
                        pin_memory=True).to(dev, non_blocking=True)
    err = fn(table.data_ptr(), gptr.data_ptr(), lr.data_ptr(), len(params),
             total, float(np.float32(mu)), int(bool(use_nesterov)),
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("fused_momentum", err)
    fused_momentum_step.launches += 1
    return params, vels, bf16s


def fused_momentum_step(params, grads, vels, lr, mu=0.0, use_nesterov=False,
                        bf16_out=None):
    """One momentum step of the group -> (params, vels, bf16s).  On the
    card the first two are the input tensors, updated in place, and
    ``bf16_out`` (a list of bf16 tensors shaped like the params, or None)
    receives the bf16 copy; on the CPU all are new tensors and a true
    ``bf16_out`` asks for the copy."""
    if params[0].device.type in ("cpu", "meta"):
        return fused_momentum_reference(params, grads, vels, lr, mu,
                                        use_nesterov, bool(bf16_out))
    return _fused_momentum_cuda(params, [g.contiguous() for g in grads],
                                vels, lr, mu, use_nesterov, bf16_out or None)


fused_momentum_step.launches = 0
