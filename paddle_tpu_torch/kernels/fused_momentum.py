"""Fused momentum step over a group of parameters: the plain PyTorch
version and the CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/fused_opt.py``
(``fused_momentum_step:186`` / ``_momentum_kernel:112``) and of the
``fused_momentum`` op's unfused path (``paddle_tpu/ops/optimizer_ops.py``
``fused_momentum:332``) without its l2_decay fold, which the op keeps on
the plain path as the reference does: per element of every member,

    v = mu v + g,   p = p - lr v   (Nesterov: p = p - (g + mu v) lr),

and an optional bf16 copy of the new p (the TPU kernel's carry output),
which the executor's param carry takes under the bf16 AMP policy.

* ``fused_momentum_reference``: the plain version, one torch op per
  operation in f32 (mu as an f32 tensor, as the reference's weak-typed
  Python float); returns new tensors.
* ``fused_momentum_step``: CPU and meta tensors take the plain version;
  CUDA tensors launch ``csrc/fused_momentum.cu``, which updates p and v
  IN PLACE and is bitwise equal to the plain version on the card.  The
  group's descriptor (each member's pointers, this step's grads among
  them, its size and block-count prefix) rides in the launch as a
  parameter block; a group of more members than one block holds takes as
  many launches as ``plan_launches`` lays out (ResNet-50's 108 take one).
  ``fused_momentum_step.launches`` counts kernel launches,
  ``fused_momentum_step.launches_carry`` those of a group with a bf16
  copy.
* ``plan_launches`` and ``cta_ranges``: the host's plan of the launches
  (at the built kernel's ``kernel_layout``) and the kernel's map from a
  CTA to its member's elements.
"""

import collections
import ctypes
import operator
import threading

import numpy as np
import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error
from ._group import requested_copies

__all__ = ["fused_momentum_reference", "fused_momentum_step",
           "kernel_layout", "plan_launches", "cta_ranges"]


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


# -- the plan: launches and CTAs ---------------------------------------------

Launch = collections.namedtuple("Launch", "first count starts")


def plan_launches(sizes, per_block, capacity):
    """Lay out a group of members of ``sizes`` elements over the kernel's
    parameter blocks -> [Launch(first member, member count, starts)].  A
    launch holds at most ``capacity`` whole members, in order, a member is
    never split across launches, and each split falls at the capacity;
    ``starts`` (int32 [count + 1], from 0) is the prefix of the members'
    block counts, max(1, ceil(size / per_block)) each.  Raises ValueError
    on an empty group."""
    if not len(sizes):
        raise ValueError("fused_momentum kernel: an empty group")
    launches = []
    for first in range(0, len(sizes), capacity):
        part = np.asarray(sizes[first:first + capacity], np.int64)
        blocks = np.maximum(1, -(-part // per_block))
        starts = np.concatenate([[0], np.cumsum(blocks)])
        if starts[-1] > 2 ** 31 - 1:
            raise ValueError("fused_momentum kernel: %d CTAs in one launch"
                             % starts[-1])
        launches.append(Launch(first, len(part), starts.astype(np.int32)))
    return launches


def cta_ranges(starts, sizes, per_block):
    """The kernel's map of one launch's CTAs -> (member, first element,
    element count) arrays, a CTA each: CTA b takes the member m with
    starts[m] <= b < starts[m + 1] (the kernel's binary search) and
    elements [(b - starts[m]) per_block, + per_block) of it, cut at its
    size."""
    blk = np.arange(int(starts[-1]), dtype=np.int64)
    member = np.searchsorted(np.asarray(starts, np.int64), blk,
                             side="right") - 1
    first = (blk - np.asarray(starts, np.int64)[member]) * per_block
    count = np.clip(np.asarray(sizes, np.int64)[member] - first, 0,
                    per_block)
    return member, first, count


# -- the CUDA kernel ---------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel():
    return _build.function("fused_momentum", "fused_momentum_f32",
                           [_VP, _VP, _VP, _I, _VP, _F, _I, _I, _VP])


def kernel_layout():
    """(elements a CTA, members a launch) of the built kernel, which the
    plan follows."""
    return tuple(_build.function("fused_momentum", name, [])()
                 for name in ("fused_momentum_per_block",
                              "fused_momentum_capacity"))


class _Group:
    """A group's host arrays, as the kernel's entry point reads them:
    ``ptrs`` int64 [n, 4] (p, v, bf16 copy or 0, grad: the last column is
    rewritten every step), ``sizes`` int64 [n] and the plan."""

    def __init__(self, params, vels, bf16s):
        self.per_block, capacity = kernel_layout()
        n = len(params)
        self.ptrs = np.zeros((n, 4), np.int64)
        self.ptrs[:, 0] = [t.data_ptr() for t in params]
        self.ptrs[:, 1] = [t.data_ptr() for t in vels]
        if bf16s:
            self.ptrs[:, 2] = [0 if t is None else t.data_ptr()
                               for t in bf16s]
        self.sizes = np.array([p.numel() for p in params], np.int64)
        self.launches = plan_launches(self.sizes, self.per_block, capacity)
        # each step's grads must read the same, in order (_check_grads)
        dev = params[0].device
        self.grad_specs = [(dev, torch.float32, p.shape) for p in params]
        self.lock = threading.Lock()


# keyed by the members' storage, which the in-place updates keep from
# step to step
_GROUPS = {}


def _group(params, vels, bf16s):
    ptr = torch.Tensor.data_ptr
    key = (tuple(map(ptr, params)), tuple(map(ptr, vels)),
           tuple(0 if b is None else b.data_ptr() for b in bf16s)
           if bf16s else None,
           tuple(map(torch.Tensor.numel, params)))
    grp = _GROUPS.get(key)
    if grp is None:
        _check_members(params, vels, bf16s)
        if len(_GROUPS) > 64:  # groups of programs no longer run
            _GROUPS.clear()
        grp = _GROUPS[key] = _Group(params, vels, bf16s)
    return grp


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
            b is not None and (b.dtype != torch.bfloat16
                               or b.shape != p.shape or b.device != dev
                               or not b.is_contiguous())
            for b, p in zip(bf16s, params))):
        raise ValueError("fused_momentum kernel: the bf16 buffers must be "
                         "dense bf16 tensors shaped like the params on %s "
                         "(or None)" % dev)


_GRAD_SPEC = operator.attrgetter("device", "dtype", "shape")


def _check_grads(grp, params, grads, lr):
    """What changes from step to step: the grads (their count, device,
    dtype, shape and density, in one pass of C-level compares against the
    group's specs) and the lr tensor."""
    if list(map(_GRAD_SPEC, grads)) != grp.grad_specs \
            or not all(map(torch.Tensor.is_contiguous, grads)):
        _explain_grads(params, grads)
    check_cuda_f32("fused_momentum", params[0].device, lr=lr)
    if lr.numel() != 1:
        raise ValueError("fused_momentum kernel: lr %s" % (tuple(lr.shape),))


def _explain_grads(params, grads):
    """Raise ValueError naming the first grad that fails a check."""
    dev = params[0].device
    if len(grads) != len(params):
        raise ValueError("fused_momentum kernel: %d grads for %d params"
                         % (len(grads), len(params)))
    for i, (p, g) in enumerate(zip(params, grads)):
        check_cuda_f32("fused_momentum", dev, grad=g)
        if g.shape != p.shape:
            raise ValueError("fused_momentum kernel: grad %d is %s, param "
                             "%s" % (i, tuple(g.shape), tuple(p.shape)))
    raise ValueError("fused_momentum kernel: the grads do not match the "
                     "group")


def _fused_momentum_cuda(params, grads, vels, lr, mu, use_nesterov, bf16s):
    fn = _kernel()
    if params[0].device.type != "cuda":
        raise ValueError("fused_momentum kernel: tensors are on %s, not a "
                         "CUDA device" % params[0].device)
    grp = _group(params, vels, bf16s)
    _check_grads(grp, params, grads, lr)
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    mu, nesterov = float(np.float32(mu)), int(bool(use_nesterov))
    with grp.lock:
        grp.ptrs[:, 3] = [g.data_ptr() for g in grads]
        ptrs, sizes = grp.ptrs.ctypes.data, grp.sizes.ctypes.data
        for launch in grp.launches:
            err = fn(ptrs + 32 * launch.first, sizes + 8 * launch.first,
                     launch.starts.ctypes.data, launch.count, lr.data_ptr(),
                     mu, nesterov, grp.per_block, stream)
            raise_on_error("fused_momentum", err)
            fused_momentum_step.launches += 1
            if bf16s is not None and any(b is not None for b in bf16s):
                fused_momentum_step.launches_carry += 1
    return params, vels, bf16s


def fused_momentum_step(params, grads, vels, lr, mu=0.0, use_nesterov=False,
                        bf16_out=None):
    """One momentum step of the group -> (params, vels, bf16s).
    ``bf16_out`` asks for the bf16 copy of the new params: a list with,
    per member, a bf16 tensor shaped like the param or None (no copy of
    that member); True (CPU only) asks for every member's.  On the card
    the first two are the input tensors, updated in place, and the list's
    tensors receive the copies; on the CPU all are new tensors, the copies
    too (None where none was asked for)."""
    if params[0].device.type in ("cpu", "meta"):
        ps, vs, copies = fused_momentum_reference(
            params, grads, vels, lr, mu, use_nesterov, bool(bf16_out))
        return ps, vs, requested_copies(copies, bf16_out)
    return _fused_momentum_cuda(params, [g.contiguous() for g in grads],
                                vels, lr, mu, use_nesterov, bf16_out or None)


fused_momentum_step.launches = 0
fused_momentum_step.launches_carry = 0
