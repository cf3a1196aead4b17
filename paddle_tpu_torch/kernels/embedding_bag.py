"""The embedding bag: routing predicate, plain PyTorch version and the
CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/embedding_bag.py`` (row 15,
``_bag_pallas:88`` / ``_bag_kernel:75``): rows [U, D] (the rows a step
pulled from the host-resident sparse table) and bags of local ids
[B, K] (-1 pads a ragged bag) -> out [B, D], out[b] = sum_k
rows[ids[b, k]] over the ids >= 0, in f32.

* ``bag_checks``: the reference's eligibility without its TPU-only
  checks (``no_pallas``, ``backend``); the ``embedding_bag`` op routes
  here under ``FLAGS_use_pallas_embedding_bag`` where every check holds.
* ``embedding_bag_reference``: the plain version.  It adds the rows in k
  order and adds +0.0 for a pad, as ``_bag_kernel`` accumulates
  ``jnp.where(valid, row, 0.0)`` one grid step at a time, so it is
  bitwise the TPU kernel's arithmetic and the CUDA kernel's.
* ``embedding_bag``: CPU and meta tensors take the plain version; CUDA
  tensors launch ``csrc/embedding_bag.cu`` or raise.
  ``embedding_bag.launches`` counts kernel launches.

The gradient (a scatter-add of the bag cotangent over the valid ids) is
the op's explicit grad lowering (``ops/manip.py``), as the reference
differentiates its jnp fallback.
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["bag_checks", "embedding_bag_reference", "embedding_bag"]


def bag_checks(rows_shape, ids_shape, dtype):
    """Ordered (reason, ok) pairs: the reference's ``bag_checks``
    (``embedding_bag.py:45``) without ``no_pallas`` and ``backend``."""
    static = all(isinstance(d, int) and d >= 0
                 for d in tuple(rows_shape) + tuple(ids_shape))
    return [
        ("symbolic_shape", static),
        ("rank", len(rows_shape) == 2 and len(ids_shape) == 2),
        ("dtype", dtype in (torch.float32, "float32")),
        ("row_width", static and len(rows_shape) == 2
         and rows_shape[1] % 128 == 0),
        ("empty", static and all(d > 0 for d in tuple(rows_shape)
                                 + tuple(ids_shape))),
    ]


def embedding_bag_reference(rows, ids):
    """Plain version: out [B, D] in rows' dtype, the rows added in k
    order, +0.0 for a pad."""
    idx = ids.long().clamp(min=0)
    valid = (ids >= 0).unsqueeze(-1)
    out = torch.zeros((ids.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for k in range(ids.shape[1]):
        out = out + torch.where(valid[:, k], rows.index_select(0, idx[:, k]),
                                0.0)
    return out


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bag_cuda(rows, ids):
    fn = _build.function("embedding_bag", "embedding_bag_f32",
                         [_VP, _VP, _VP, _I, _I, _I, _LL, _VP])
    dev = rows.device
    check_cuda_f32("embedding_bag", dev, rows=rows)
    if not all(ok for _, ok in bag_checks(tuple(rows.shape),
                                          tuple(ids.shape), rows.dtype)):
        raise ValueError("embedding_bag kernel: rows %s, ids %s is not a "
                         "shape the kernel takes (bag_checks)"
                         % (tuple(rows.shape), tuple(ids.shape)))
    if ids.device != dev or ids.dtype != torch.int64 \
            or not ids.is_contiguous():
        raise ValueError("embedding_bag kernel: ids must be a dense int64 "
                         "tensor on %s, got %s on %s" % (dev, ids.dtype,
                                                         ids.device))
    if rows.data_ptr() % 16:
        raise ValueError("embedding_bag kernel: rows must be 16-byte "
                         "aligned")
    (u, d), (bags, k) = rows.shape, ids.shape
    out = torch.empty((bags, d), dtype=rows.dtype, device=dev)
    err = fn(rows.data_ptr(), ids.data_ptr(), out.data_ptr(), bags, k, d, u,
             torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error("embedding_bag", err)
    embedding_bag.launches += 1
    return out


def embedding_bag(rows, ids):
    """out[b] = sum_k rows[ids[b, k]] over ids >= 0 -> [B, D]."""
    if rows.device.type == "meta":
        return rows.new_empty((ids.shape[0], rows.shape[1]))
    if rows.device.type == "cpu":
        return embedding_bag_reference(rows, ids)
    return _bag_cuda(rows.contiguous(), ids.contiguous())


embedding_bag.launches = 0
