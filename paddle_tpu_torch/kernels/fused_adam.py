"""Fused Adam step over a group of parameters: the plain PyTorch version
and the CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/fused_opt.py``
(``fused_adam_step:133`` / ``_adam_kernel:96``) and of the ``fused_adam``
op's unfused path (``paddle_tpu/ops/optimizer_ops.py:384``): per member i
of the group, with lr_t_i = lr * sqrt(1 - beta2_pow_i) / (1 - beta1_pow_i)
(each member keeps its own bias correction),

    m1 = b1 m1 + (1 - b1) g,   m2 = b2 m2 + ((1 - b2) g) g,
    p  = p - lr_t_i (m1 / (sqrt(m2) + eps)),

the beta pows advance by one factor of b1 / b2, and an optional bf16
copy of the new p is written (the TPU kernel's carry output): the
executor's param carry under the bf16 AMP policy takes it for each
carried member.

* ``fused_adam_reference``: the plain version, one torch op per
  operation in f32 (scalars as f32 tensors, as the reference's
  ``jnp.asarray(beta1, dt)``); returns new tensors.
* ``fused_adam_step``: CPU and meta tensors take the plain version; CUDA
  tensors launch ``csrc/fused_adam.cu`` once for the whole group, which
  updates p, m1, m2 and the beta pows IN PLACE and is bitwise equal to
  the plain version on the card.  ``fused_adam_step.launches`` counts
  kernel launches, ``fused_adam_step.launches_carry`` those that wrote a
  bf16 copy.
"""

import ctypes

import numpy as np
import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error
from ._group import group_table, requested_copies

__all__ = ["fused_adam_reference", "fused_adam_step", "adam_lr_t"]


def _stack(pows):
    return torch.cat([b if b.dim() == 1 else b.reshape(1) for b in pows])


def adam_lr_t(lr, b1pows, b2pows):
    """Per-member lr_t [n] f32 from lr [1] and the members' beta pows, on
    the device they live on and with no host sync."""
    return lr.reshape(()) * torch.sqrt(1 - _stack(b2pows)) \
        / (1 - _stack(b1pows))


def fused_adam_reference(params, grads, m1s, m2s, lr, b1pows, b2pows,
                         beta1=0.9, beta2=0.999, epsilon=1e-8,
                         bf16_out=False):
    """-> (params, m1s, m2s, b1pows, b2pows, bf16s or None), all new."""
    dev, dt = params[0].device, params[0].dtype
    b1 = torch.tensor(beta1, dtype=dt, device=dev)
    b2 = torch.tensor(beta2, dtype=dt, device=dev)
    lr_t = adam_lr_t(lr, b1pows, b2pows)
    ps, m1n, m2n = [], [], []
    for i, (p, g, m1, m2) in enumerate(zip(params, grads, m1s, m2s)):
        g = g.to(dt)
        a = b1 * m1 + (1 - b1) * g
        b = b2 * m2 + (1 - b2) * g * g
        ps.append(p - lr_t[i] * (a / (torch.sqrt(b) + epsilon)))
        m1n.append(a)
        m2n.append(b)
    return (ps, m1n, m2n, [b * b1 for b in b1pows], [b * b2 for b in b2pows],
            [p.to(torch.bfloat16) for p in ps] if bf16_out else None)


_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _kernel():
    return _build.function("fused_adam", "fused_adam_f32",
                           [_VP, _VP, _VP, _I, _LL] + [_F] * 5 + [_VP])


def _table(params, grads, m1s, m2s, lr, b1pows, b2pows, bf16s):
    """(device table, total blocks) of the group, its members checked and
    the table built on its first step; every step checks what changes,
    the grads."""
    _check_grads(params, grads, lr)
    # rows as csrc/fused_adam.cu reads them: p, m1, m2, beta1_pow,
    # beta2_pow, bf16 copy
    rows = [[t.data_ptr() for t in ts]
            for ts in (params, m1s, m2s, b1pows, b2pows)]
    rows.append([0 if t is None else t.data_ptr() for t in bf16s]
                if bf16s else [0] * len(params))
    return group_table(rows, [p.numel() for p in params], params[0].device,
                       lambda: _check(params, grads, m1s, m2s, lr, b1pows,
                                      b2pows, bf16s))


def _check(params, grads, m1s, m2s, lr, b1pows, b2pows, bf16s):
    dev = params[0].device
    n = len(params)
    if not n or any(len(ts) != n for ts in (grads, m1s, m2s, b1pows,
                                            b2pows)):
        raise ValueError("fused_adam kernel: a group of %d params with %s "
                         "grads/m1/m2/beta pows" % (
                             n, [len(ts) for ts in (grads, m1s, m2s, b1pows,
                                                    b2pows)]))
    for i, (p, g, m1, m2, b1p, b2p) in enumerate(zip(
            params, grads, m1s, m2s, b1pows, b2pows)):
        check_cuda_f32("fused_adam", dev, param=p, grad=g, moment1=m1,
                       moment2=m2, beta1_pow=b1p, beta2_pow=b2p)
        if not (p.shape == g.shape == m1.shape == m2.shape) \
                or b1p.numel() != 1 or b2p.numel() != 1:
            raise ValueError("fused_adam kernel: member %d: param %s, grad "
                             "%s, moments %s %s, beta pows %s %s"
                             % (i, tuple(p.shape), tuple(g.shape),
                                tuple(m1.shape), tuple(m2.shape),
                                tuple(b1p.shape), tuple(b2p.shape)))
    _check_grads(params, grads, lr)
    if bf16s is not None and len(bf16s) != n:
        raise ValueError("fused_adam kernel: %d bf16 buffers for %d params"
                         % (len(bf16s), n))
    for i, (p, b) in enumerate(zip(params, bf16s or ())):
        if b is None:
            continue
        if b.dtype != torch.bfloat16 or b.shape != p.shape \
                or b.device != dev or not b.is_contiguous():
            raise ValueError("fused_adam kernel: bf16 buffer %d is %s %s "
                             "on %s" % (i, b.dtype, tuple(b.shape),
                                        b.device))


def _check_grads(params, grads, lr):
    dev = params[0].device
    if len(grads) != len(params):
        raise ValueError("fused_adam kernel: %d grads for %d params"
                         % (len(grads), len(params)))
    for i, (p, g) in enumerate(zip(params, grads)):
        if g.device != dev or g.dtype != torch.float32 \
                or g.shape != p.shape:
            raise ValueError("fused_adam kernel: grad %d is %s %s on %s, "
                             "param %s" % (i, g.dtype, tuple(g.shape),
                                           g.device, tuple(p.shape)))
    check_cuda_f32("fused_adam", dev, lr=lr)
    if lr.numel() != 1:
        raise ValueError("fused_adam kernel: lr %s" % (tuple(lr.shape),))


def _fused_adam_cuda(params, grads, m1s, m2s, lr, b1pows, b2pows, beta1,
                     beta2, epsilon, bf16s):
    fn = _kernel()
    if params[0].device.type != "cuda":
        raise ValueError("fused_adam kernel: tensors are on %s, not a CUDA "
                         "device" % params[0].device)
    dev = params[0].device
    table, total = _table(params, grads, m1s, m2s, lr, b1pows, b2pows,
                          bf16s)
    # lr_t from the beta pows before the kernel advances them
    lr_t = adam_lr_t(lr, b1pows, b2pows)
    gptr = torch.tensor([g.data_ptr() for g in grads], dtype=torch.int64,
                        pin_memory=True).to(dev, non_blocking=True)
    b1, b2 = np.float32(beta1), np.float32(beta2)
    # 1 - b in f32, as the plain version's (1 - b1) on an f32 tensor
    err = fn(table.data_ptr(), gptr.data_ptr(), lr_t.data_ptr(),
             len(params), total, float(b1), float(b2),
             float(np.float32(1) - b1), float(np.float32(1) - b2),
             float(epsilon), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("fused_adam", err)
    fused_adam_step.launches += 1
    if bf16s is not None and any(b is not None for b in bf16s):
        fused_adam_step.launches_carry += 1
    return params, m1s, m2s, b1pows, b2pows, bf16s


def fused_adam_step(params, grads, m1s, m2s, lr, b1pows, b2pows,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, bf16_out=None):
    """One Adam step of the group -> (params, m1s, m2s, b1pows, b2pows,
    bf16s).  ``bf16_out`` asks for the bf16 copy of the new params: a
    list with, per member, a bf16 tensor shaped like the param or None
    (no copy of that member); True (CPU only) asks for every member's.
    On the card the first five are the input tensors, updated in place,
    and the list's tensors receive the copies; on the CPU all are new
    tensors, the copies too (None where none was asked for)."""
    if params[0].device.type in ("cpu", "meta"):
        out = fused_adam_reference(params, grads, m1s, m2s, lr, b1pows,
                                   b2pows, beta1, beta2, epsilon,
                                   bool(bf16_out))
        return out[:5] + (requested_copies(out[5], bf16_out),)
    return _fused_adam_cuda(params, [g.contiguous() for g in grads], m1s,
                            m2s, lr, b1pows, b2pows, beta1, beta2, epsilon,
                            bf16_out or None)


fused_adam_step.launches = 0
fused_adam_step.launches_carry = 0
