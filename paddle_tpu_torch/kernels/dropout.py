"""Dropout with the byte-quantised keep draw: the plain PyTorch version
and the CUDA kernel.

The JAX package does the ``dropout`` op in jnp (``paddle_tpu/ops/nn.py``
``dropout:602``, its mask from ``ops/common.py`` ``bernoulli_bytes``), so
this is no row of the kernel table: on the card the op's mask is drawn by
``csrc/dropout.cu`` because the plain Philox would launch dozens of
elementwise kernels per op.  Both give the same bytes: keep element e iff
byte e of the Philox stream keyed by ``seed`` (``philox.keep_bytes``) is
below ``thr``; kept values are ``x / q`` (upscale_in_train) or ``x``
(downgrade_in_infer), dropped ones 0.

A bf16 x (the attention probabilities under the bf16 AMP policy) takes
the kernel's bf16 instantiation: x / q in f32, rounded once to bf16,
which is the correctly rounded bf16 quotient (q has at most 8
significant bits), as the plain version and the reference compute it.

* ``dropout_reference``: the plain version.
* ``dropout``: CPU and meta tensors take the plain version; a CUDA tensor
  of float32 or bfloat16 launches the kernel, any other raises.
  ``dropout.launches`` counts launches (``dropout.launches_bf16`` those of
  the bf16 instantiation).
"""

import ctypes

import torch

from . import _build, philox
from ._checks import check_cuda, raise_on_error

__all__ = ["true_divide", "dropout_reference", "dropout"]


def true_divide(x, q):
    """x / q rounded as IEEE division, as the reference divides: PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    can differ in the last bit, so q goes in as a 0-d tensor on x's
    device (a fill, no host copy)."""
    return x / torch.full((), q, dtype=x.dtype, device=x.device)


def dropout_reference(x, seed, thr, q, upscale=True):
    """-> (out like x, mask uint8 like x).  ``seed``: the two key words;
    ``thr``: byte threshold 0..256; ``q``: the upscale divisor."""
    keep = philox.keep_bytes(seed, thr, x.shape, x.device)
    kept = true_divide(x, q) if upscale else x
    out = torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    return out, keep.to(torch.uint8)


_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


_SYMBOLS = {torch.float32: "dropout_fwd_f32",
            torch.bfloat16: "dropout_fwd_bf16"}


def _kernel(dtype=torch.float32):
    return _build.function(
        "dropout", _SYMBOLS[dtype],
        [_VP] * 3 + [ctypes.c_longlong, _U, _U, _U, ctypes.c_float, _I,
                     _VP])


def _dropout_cuda(x, seed, thr, q, upscale):
    fn = _kernel(x.dtype if x.dtype in _SYMBOLS else torch.float32)
    check_cuda("dropout", x.device, tuple(_SYMBOLS), x=x)
    if x.numel() == 0 or not 0 <= thr <= 256 or not q > 0:
        raise ValueError("dropout kernel: %d elements, thr %r, q %r"
                         % (x.numel(), thr, q))
    k0, k1 = philox.seed_words(seed)
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), mask.data_ptr(), x.numel(), k0,
             k1, int(thr), float(q), int(bool(upscale)), stream)
    raise_on_error("dropout", err)
    dropout.launches += 1
    if x.dtype == torch.bfloat16:
        dropout.launches_bf16 += 1
    return out, mask


def dropout(x, seed, thr, q, upscale=True):
    """-> (out, mask uint8), both shaped like x.  ``seed`` is a pair of
    key words held on the host."""
    if x.device.type in ("cpu", "meta"):
        return dropout_reference(x, seed, thr, q, upscale)
    return _dropout_cuda(x.contiguous(), seed, thr, q, upscale)


dropout.launches = 0
dropout.launches_bf16 = 0
