"""Column statistics of a bf16 [M, C] matrix: the plain PyTorch versions
and the CUDA kernels.

Counterpart of the two Pallas kernels of ``tools/bench_reduce_pallas.py``
(the batch-norm statistics pass of a conv output in its channels-last
[N H W, C] view, which that microbenchmark measures; no module of the JAX
package calls them):

* ``stats`` (row 16, ``pallas_stats_one:85`` / ``_stats_kernel:72``):
  (sum over rows of (x + c), sum of (x + c)^2), [C] f32 each, for bf16 x
  and an f32 scalar c (a [1] or [1, 1] tensor);
* ``affine_stats`` (row 17, ``pallas_affine_stats:127`` /
  ``_affine_stats_kernel:112``): y = x a + b in f32, returned as bf16,
  with the column sum and sum of squares of the f32 y (before the bf16
  rounding), for a, b [C] (or [1, C]) f32.

Each wrapper takes its plain version for CPU and meta tensors and
launches ``csrc/channel_stats.cu`` for CUDA tensors, raising on anything
the kernel does not take; each counts its launches in
``<wrapper>.launches`` (a launch is the partial-sum pass and the
reduction of its partials, one count).  ``tools/torch_bench_reduce.py``
times them.
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["stats_reference", "affine_stats_reference", "stats",
           "affine_stats"]

THREADS = 256  # csrc/channel_stats.cu kThreads
_sm_count = {}


def stats_reference(x, c):
    """Plain version of row 16 -> (s [C], ss [C]) in f32."""
    xf = x.float() + c.reshape(()).float()
    return xf.sum(0), (xf * xf).sum(0)


def affine_stats_reference(x, a, b):
    """Plain version of row 17 -> (y bf16 [M, C], s [C], ss [C])."""
    y = x.float() * a.reshape(-1).float() + b.reshape(-1).float()
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check_x(kernel, x):
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous() \
            or x.shape[0] == 0 or x.shape[1] % 8 or x.shape[1] == 0 \
            or x.shape[1] // 8 > THREADS or x.data_ptr() % 16:
        raise ValueError("%s kernel: x must be a dense, 16-byte aligned "
                         "bf16 [M, C] with C %% 8 == 0 and C <= %d, got %s "
                         "%s" % (kernel, 8 * THREADS, x.dtype,
                                 tuple(x.shape)))


def _blocks(x):
    """CTAs of the partial pass: two per SM, or fewer where the rows run
    out first."""
    dev = x.device
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    m, c = x.shape
    rows_per_step = THREADS // (c // 8)
    return max(1, min(-(-m // rows_per_step), 2 * _sm_count[dev]))


def _outputs(x, blocks):
    f32 = dict(dtype=torch.float32, device=x.device)
    c = x.shape[1]
    return (torch.empty(2 * blocks * c, **f32), torch.empty(c, **f32),
            torch.empty(c, **f32))


def _stats_cuda(x, c):
    fn = _build.function("channel_stats", "channel_stats_bf16",
                         [_VP] * 5 + [_LL, _I, _I, _VP])
    _check_x("channel_stats", x)
    check_cuda_f32("channel_stats", x.device, c=c)
    if c.numel() != 1:
        raise ValueError("channel_stats kernel: c %s is not a scalar"
                         % (tuple(c.shape),))
    blocks = _blocks(x)
    part, s, ss = _outputs(x, blocks)
    err = fn(x.data_ptr(), c.data_ptr(), part.data_ptr(), s.data_ptr(),
             ss.data_ptr(), x.shape[0], x.shape[1], blocks,
             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("channel_stats", err)
    stats.launches += 1
    return s, ss


def _affine_stats_cuda(x, a, b):
    fn = _build.function("channel_stats", "affine_stats_bf16",
                         [_VP] * 7 + [_LL, _I, _I, _VP])
    _check_x("affine_stats", x)
    check_cuda_f32("affine_stats", x.device, a=a, b=b)
    if a.numel() != x.shape[1] or b.numel() != x.shape[1]:
        raise ValueError("affine_stats kernel: a %s, b %s for %d columns"
                         % (tuple(a.shape), tuple(b.shape), x.shape[1]))
    blocks = _blocks(x)
    part, s, ss = _outputs(x, blocks)
    y = torch.empty_like(x)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
             part.data_ptr(), s.data_ptr(), ss.data_ptr(), x.shape[0],
             x.shape[1], blocks,
             torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error("affine_stats", err)
    affine_stats.launches += 1
    return y, s, ss


def stats(x, c):
    """Row 16: (sum over rows of (x + c), sum of (x + c)^2), f32 [C]."""
    if x.device.type in ("cpu", "meta"):
        return stats_reference(x, c)
    return _stats_cuda(x, c)


stats.launches = 0


def affine_stats(x, a, b):
    """Row 17: (y = x a + b as bf16, column sum of y, sum of y^2)."""
    if x.device.type in ("cpu", "meta"):
        return affine_stats_reference(x, a, b)
    return _affine_stats_cuda(x, a, b)


affine_stats.launches = 0
