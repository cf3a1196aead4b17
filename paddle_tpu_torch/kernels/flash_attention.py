"""Flash attention forward: the plain PyTorch version and the CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/flash_attention.py``
(``_fwd_pallas:267`` / ``_fwd_kernel:49``): softmax(q k^T * scale + bias)
v over [B, H, S, D] operands with an optional additive bias
[B, 1 or H, Sq, Sk] and causal masking, returning the output and the
row log-sum-exp.

* ``flash_attention_reference`` is the plain version: the reference's
  ``_ref_attention`` plus the lse.
* ``flash_attention`` dispatches on where q lives: CPU (and meta, for
  shape inference) tensors take the plain version; a CUDA tensor launches
  the hand-written kernel (``csrc/flash_attention.cu``) at every shape,
  or the call raises.  The TPU package takes its kernel only at Sk >= 1024
  with 128-multiple blocks, a cutoff measured on the TPU; the port has no
  such gate.  ``flash_attention.launches`` counts kernel launches.
"""

import ctypes

import torch

from . import _build
from ._checks import check_cuda_f32, raise_on_error

__all__ = ["flash_attention_reference", "flash_attention"]

# finite, as in the reference: a fully masked row averages V, never NaN
_MASK = -1e30
_MAX_D = 128


def flash_attention_reference(q, k, v, bias=None, causal=False,
                              sm_scale=None):
    """(out [B, H, Sq, D] in q's dtype, lse [B, H, Sq, 1] float32)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2:]
        above = torch.arange(sk, device=s.device)[None, :] \
            > torch.arange(sq, device=s.device)[:, None]
        s = s.masked_fill(above, _MASK)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel():
    return _build.function(
        "flash_attention", "flash_attention_fwd_f32",
        [_VP] * 6 + [_I] * 7 + [ctypes.c_float] + [_LL] * 9 + [_VP])


def _check(q, k, v, bias):
    # q, k, v may be strided views (a transposed head split) as long as
    # the head dim is dense; the bias must be dense
    check_cuda_f32("flash_attention", q.device, contiguous=False, q=q, k=k,
                   v=v)
    if bias is not None:
        check_cuda_f32("flash_attention", q.device, bias=bias)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention kernel: want q, k, v [B, H, S, D]")
    bb, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (bb, h, sk, d) or v.shape != k.shape:
        raise ValueError("flash_attention kernel: shapes disagree: q %s, "
                         "k %s, v %s" % (tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError("flash_attention kernel: %s's head dim is not "
                             "dense (stride %d)" % (name, t.stride(3)))
    if not 0 < d <= _MAX_D:
        raise ValueError("flash_attention kernel: head_dim %d not in "
                         "[1, %d]" % (d, _MAX_D))
    if min(bb, h, sq, sk) <= 0 or bb > 65535 or h > 65535:
        raise ValueError("flash_attention kernel: empty or oversized "
                         "geometry q %s, k %s" % (tuple(q.shape),
                                                  tuple(k.shape)))
    if bias is not None and (bias.dim() != 4 or bias.shape[0] != bb
                             or bias.shape[1] not in (1, h)
                             or tuple(bias.shape[2:]) != (sq, sk)):
        raise ValueError("flash_attention kernel: bias %s, want [%d, 1|%d, "
                         "%d, %d]" % (tuple(bias.shape), bb, h, sq, sk))


def _flash_cuda(q, k, v, bias, causal, sm_scale):
    fn = _kernel()
    _check(q, k, v, bias)
    bb, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty((bb, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bb, h, sq, 1), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), lse.data_ptr(), bb, h, sq, sk, d,
             0 if bias is None else bias.shape[1], int(bool(causal)),
             float(sm_scale), *strides, stream)
    raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None):
    """Attention forward -> (out [B, H, Sq, D], lse [B, H, Sq, 1] f32).
    CPU and meta tensors take ``flash_attention_reference``; CUDA tensors
    launch the kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type in ("cpu", "meta"):
        return flash_attention_reference(q, k, v, bias, causal, sm_scale)
    return _flash_cuda(q, k, v, bias, causal, sm_scale)


flash_attention.launches = 0
