"""Flash attention forward and backward: the plain PyTorch versions and
the CUDA kernels.

Counterpart of ``paddle_tpu/pallas_kernels/flash_attention.py``
(``_fwd_pallas:267`` / ``_fwd_kernel:49``; ``_bwd_pallas:332`` /
``_bwd_dq_kernel:112`` and ``_bwd_dkv_kernel:157``; the custom VJP
``_flash_b:469``): softmax(q k^T * scale + bias) v over [B, H, S, D]
operands with an optional additive bias [B, 1 or H, Sq, Sk] and causal
masking, returning the output and the row log-sum-exp; the backward
recomputes the probabilities from that lse.

* ``flash_attention_reference`` / ``flash_attention_bwd_reference`` are
  the plain versions: the reference's ``_ref_attention`` plus the lse,
  and the recompute backward of its Pallas kernels.
* ``flash_attention`` and ``flash_attention_bwd`` dispatch on where q
  lives: CPU (and meta, for shape inference) tensors take the plain
  version; a CUDA tensor launches the hand-written kernels
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) at every
  shape, or the call raises.  The forward runs on the tensor cores in
  3xTF32.  The backward is one fused kernel for dQ, dK and dV
  (``flash_attention_bwd_fused``).  The TPU package takes its
  kernel only at Sk >= 1024 with 128-multiple blocks, a cutoff measured
  on the TPU; the port has no such gate.  ``flash_attention.launches``
  and ``flash_attention_bwd_fused.launches`` count kernel launches.
* ``FlashAttention`` (``flash_attention_train``) is the differentiable
  form, a ``torch.autograd.Function`` whose backward is the kernels'.

The small-sequence training attention (``small_attention_fwd:618`` /
``_small_fwd_kernel:534``, ``small_attention_bwd:653`` /
``_small_bwd_kernel:563``, ``small_attention_shapes_ok:510``):
softmax(q k^T * scale + bias) with attention-prob dropout applied inside
the kernel (keep iff u32 < ``keep_threshold(p)``, kept probabilities
times ``inv_realized_q``), for S <= 256, S % 128 == 0 and D in {64, 128}.
The forward returns out and the row lse; the backward recomputes the
probabilities from that lse and re-draws the mask, element
``((b * H + h) * S + i) * S + j`` of the port's Philox stream keyed by
the seed words, so no [B, H, S, S] tensor is kept.
``small_attention_fwd_reference`` / ``small_attention_bwd_reference`` are
the plain versions; ``small_attention_fwd`` / ``small_attention_bwd``
launch ``csrc/small_attention.cu`` / ``csrc/small_attention_bwd.cu`` (the
fused backward's core with the mask) on a CUDA tensor (counted in
``.launches``); ``SmallAttention``
(``small_attention``) is the differentiable form.
"""

import ctypes

import torch

from . import _build, philox
from ._checks import check_cuda_f32, check_seed_tensor, raise_on_error

__all__ = ["flash_attention_reference", "flash_attention", "FWD_WARPS",
           "FWD_DEFAULT_WARPS", "flash_attention_fwd_ctas_per_sm",
           "attention_delta", "flash_attention_bwd_reference",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference", "flash_attention_bwd",
           "flash_attention_bwd_fused",
           "FlashAttention", "flash_attention_train",
           "small_attention_shapes_ok", "small_attention_fwd_reference",
           "small_attention_fwd", "small_attention_bwd_reference",
           "small_attention_bwd", "small_attention_bwd_fused",
           "SmallAttention", "small_attention"]

# finite, as in the reference: a fully masked row averages V, never NaN
_MASK = -1e30
# a row whose lse is below this had every score at _MASK: there f32 holds
# lse = -1e30 (not -1e30 + log(Sk)), so exp(s - lse) is 1, not 1 / Sk
_MASKED_ROW = -1e29
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


def _scores(q, k, bias, causal, sm_scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2:]
        above = torch.arange(sk, device=s.device)[None, :] \
            > torch.arange(sq, device=s.device)[:, None]
        s = s.masked_fill(above, _MASK)
    return s


def attention_delta(out, do):
    """rowsum(dO * O) [B, H, Sq, 1] f32, the backward's delta."""
    return (do.float() * out.float()).sum(dim=-1, keepdim=True)


def _probs(q, k, bias, lse, causal, sm_scale):
    """p = exp(s - lse), recomputed; a fully masked row's p is the
    forward's 1 / Sk."""
    s = _scores(q, k, bias, causal, sm_scale)
    p = torch.exp(s - lse)
    return torch.where(lse < _MASKED_ROW, p / s.shape[-1], p)


def flash_attention_bwd_dq_reference(q, k, v, bias, do, lse, delta,
                                     causal=False, sm_scale=None):
    """Plain dQ: ds = p (dO v^T - delta) scale, dQ = ds k."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p = _probs(q, k, bias, lse, causal, sm_scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta) * sm_scale
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse, delta,
                                      causal=False, sm_scale=None):
    """Plain (dK, dV): dK = ds^T q, dV = p^T dO."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p = _probs(q, k, bias, lse, causal, sm_scale)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - delta) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                  causal=False, sm_scale=None):
    """(dq, dk, dv) by the recompute scheme of the reference's backward
    kernels, from the forward's out and lse."""
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, bias, do, lse, delta,
                                          causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, bias, do, lse,
                                               delta, causal, sm_scale)
    return dq, dk, dv


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel():
    return _build.function(
        "flash_attention", "flash_attention_fwd_f32",
        [_VP] * 6 + [_I] * 7 + [ctypes.c_float] + [_LL] * 9 + [_I, _VP])


# the forward kernel's CTA shapes: warps a CTA, 16 query rows each
FWD_WARPS = (2, 4, 8)
# 64 query rows a CTA: on an H100 the fastest of the three at B = 1 and 8
# (BERT-base heads, S = 128) and within 1% of 128 rows at B = 32, so one
# shape serves every batch (tools/torch_flash_bwd_bench.py --sweep;
# PERF.md)
FWD_DEFAULT_WARPS = 4


def flash_attention_fwd_ctas_per_sm(head_dim, warps):
    """CTAs of the forward kernel an SM holds at once for this head width
    and CTA shape (a report of its occupancy; needs the card)."""
    fn = _build.function("flash_attention", "flash_attention_fwd_ctas_per_sm",
                         [_I, _I, ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    raise_on_error("flash_attention", fn(int(head_dim), int(warps),
                                         ctypes.byref(n)))
    return n.value


def _bwd_kernel():
    return _build.function("flash_attention_bwd", "flash_attention_bwd_f32",
                           [_VP] * 10 + [_I] * 7
                           + [ctypes.c_float, _VP, _VP])


def _check(q, k, v, bias, kernel="flash_attention"):
    # q, k, v may be strided views (a transposed head split) as long as
    # the head dim is dense; the bias must be dense
    check_cuda_f32(kernel, q.device, contiguous=False, q=q, k=k, v=v)
    if bias is not None:
        check_cuda_f32(kernel, q.device, bias=bias)
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


def _flash_cuda(q, k, v, bias, causal, sm_scale, warps=None):
    fn = _kernel()
    if warps is not None and warps not in FWD_WARPS:
        raise ValueError("flash_attention kernel: warps %r not in %s"
                         % (warps, FWD_WARPS))
    _check(q, k, v, bias)
    bb, h, sq, d = q.shape
    sk = k.shape[2]
    if warps is None:
        warps = FWD_DEFAULT_WARPS
    out = torch.empty((bb, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bb, h, sq, 1), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), lse.data_ptr(), bb, h, sq, sk, d,
             0 if bias is None else bias.shape[1], int(bool(causal)),
             float(sm_scale), *strides, warps, stream)
    raise_on_error("flash_attention", err)
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    warps=None):
    """Attention forward -> (out [B, H, Sq, D], lse [B, H, Sq, 1] f32).
    CPU and meta tensors take ``flash_attention_reference``; CUDA tensors
    launch the kernel, with ``warps`` a CTA (``FWD_WARPS``; None:
    ``FWD_DEFAULT_WARPS``), so that a check or a sweep can reach every
    tile."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type in ("cpu", "meta"):
        return flash_attention_reference(q, k, v, bias, causal, sm_scale)
    return _flash_cuda(q, k, v, bias, causal, sm_scale, warps)


flash_attention.launches = 0


def _check_bwd(kernel, q, k, v, bias, do, lse, delta):
    _check(q, k, v, bias, kernel)
    check_cuda_f32(kernel, q.device, contiguous=False, do=do)
    check_cuda_f32(kernel, q.device, lse=lse, delta=delta)
    bb, h, sq, d = q.shape
    if tuple(do.shape) != (bb, h, sq, d) or do.stride(3) != 1:
        raise ValueError("%s kernel: dO %s (head-dim stride %d), want a "
                         "dense-head-dim %s" % (kernel, tuple(do.shape),
                                                do.stride(3),
                                                tuple(q.shape)))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.numel() != bb * h * sq:
            raise ValueError("%s kernel: %s %s, want [%d, %d, %d, 1]"
                             % (kernel, name, tuple(t.shape), bb, h, sq))


def flash_attention_bwd_fused(q, k, v, bias, do, lse, delta, causal=False,
                              sm_scale=None):
    """(dQ, dK, dV) dense [B, H, S, D] by the fused CUDA kernel
    (``csrc/flash_attention_bwd.cu``); CUDA tensors only: the plain
    versions are ``flash_attention_bwd_dq_reference`` and
    ``flash_attention_bwd_dkv_reference``."""
    fn = _bwd_kernel()
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_bwd("flash_attention_bwd_fused", q, k, v, bias, do, lse, delta)
    bb, h, sq, d = q.shape
    # the kernel adds each key tile's share of dQ into it
    dq = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, do) for s in t.stride()[:3]])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None, do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), bb, h, sq, k.shape[2], d,
             0 if bias is None else bias.shape[1], int(bool(causal)),
             float(sm_scale), strides,
             torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("flash_attention_bwd_fused", err)
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_bwd_fused.launches = 0


def flash_attention_bwd_ctas_per_sm(head_dim):
    """CTAs of the fused backward kernel an SM holds at once for this head
    width (a report of its occupancy; needs the card)."""
    fn = _build.function("flash_attention_bwd",
                         "flash_attention_bwd_ctas_per_sm",
                         [_I, ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    raise_on_error("flash_attention_bwd_fused",
                   fn(int(head_dim), ctypes.byref(n)))
    return n.value


def flash_attention_bwd(q, k, v, bias, out, lse, do, causal=False,
                        sm_scale=None):
    """Attention backward -> (dq, dk, dv), dense [B, H, S, D], from the
    forward's out and lse.  CPU and meta tensors take
    ``flash_attention_bwd_reference``; CUDA tensors launch the fused
    kernel."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type in ("cpu", "meta"):
        return flash_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                             causal, sm_scale)
    return flash_attention_bwd_fused(q, k, v, bias, do, lse.contiguous(),
                                     attention_delta(out, do), causal,
                                     sm_scale)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention (the reference's custom-VJP ``_flash_b``):
    forward by ``flash_attention``, backward by ``flash_attention_bwd``
    from the saved out and lse.  The bias is a mask and gets no
    gradient.  Written in the forward / setup_context form, so
    ``torch.func`` transforms can use it too."""

    @staticmethod
    def forward(q, k, v, bias, causal, sm_scale):
        return flash_attention(q, k, v, bias, causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, causal, sm_scale = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, bias=None, causal=False, sm_scale=None):
    """Attention output [B, H, Sq, D], differentiable in q, k and v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bias, causal, sm_scale)[0]


# -- small-sequence attention with in-kernel dropout --------------------------

_SMALL_SEQ_MAX = 256


def small_attention_shapes_ok(q_shape, k_shape, bias_shape, causal, layout):
    """Static predicate shared by the op's forward and grad lowerings —
    BOTH must route identically or the backward replays a wrong mask."""
    if layout != "BHSD" or causal:
        return False
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    B, H, S, D = q_shape
    if not all(isinstance(d, int) for d in (B, H, S, D)):
        return False
    if k_shape[2] != S or k_shape[3] != D or S > _SMALL_SEQ_MAX \
            or S % 128 != 0:
        return False
    if D not in (64, 128):
        return False
    if bias_shape is not None:
        # the kernel tiles the bias as full [Sq, Sk] blocks: broadcast
        # shapes like [B,1,1,S] must take the composed fallback
        if (len(bias_shape) != 4 or bias_shape[1] not in (1, H)
                or bias_shape[2] != S or bias_shape[3] != S):
            return False
    return True


def _small_keep(seed, thr, q):
    """The [B, H, S, S] keep mask of the small kernels (None at p = 0;
    no data on the meta device)."""
    if thr is None or q.device.type == "meta":
        return None
    bb, h, s, _d = q.shape
    return philox.keep_mask(seed, thr, (bb, h, s, s), q.device)


def _dropped_probs(prob, keep, thr):
    if keep is None:
        return prob
    return torch.where(keep, prob * philox.inv_realized_q(thr),
                       torch.zeros((), dtype=prob.dtype, device=prob.device))


def small_attention_fwd_reference(q, k, v, bias, sm_scale, dropout_prob,
                                  seed):
    """Plain forward -> (out [B, H, S, D] in q's dtype, lse [B, H, S, 1]
    f32): the reference's ``_small_fwd_kernel`` per head, the mask drawn
    from the stream keyed by ``seed`` (two key words)."""
    thr = philox.keep_threshold(dropout_prob)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    prob = _dropped_probs(p / l, _small_keep(seed, thr, q), thr)
    out = torch.einsum("bhqk,bhkd->bhqd", prob, v.float())
    return out.to(q.dtype), m + torch.log(l)


def small_attention_bwd_reference(q, k, v, bias, sm_scale, dropout_prob,
                                  seed, out, lse, do):
    """Plain backward -> (dq, dk, dv): probabilities from the forward's
    lse, the mask re-drawn from ``seed`` (two key words, or the forward's
    int32 Seed tensor, read on the host), delta = rowsum(dO . O)."""
    thr = philox.keep_threshold(dropout_prob)
    if thr is not None and q.device.type != "meta":
        seed = philox.seed_words(seed)
    keep = _small_keep(seed, thr, q)
    delta = attention_delta(out, do)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    prob = torch.exp(s - lse)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", _dropped_probs(prob, keep, thr),
                      dof)
    dp = _dropped_probs(torch.einsum("bhqd,bhkd->bhqk", dof, v.float()),
                        keep, thr)
    ds = prob * (dp - delta) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _small_check(kernel, q, k, v, bias, do=None):
    check_cuda_f32(kernel, q.device, contiguous=False, q=q, k=k, v=v)
    if do is not None:
        check_cuda_f32(kernel, q.device, contiguous=False, do=do)
    if bias is not None:
        check_cuda_f32(kernel, q.device, bias=bias)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or (do is not None and do.shape != q.shape):
        raise ValueError("%s kernel: want q, k, v%s of one shape [B, H, S, "
                         "D], got %s" % (kernel, ", dO" if do is not None
                                         else "", [tuple(t.shape) for t in
                                                   (q, k, v, do)
                                                   if t is not None]))
    if not small_attention_shapes_ok(
            tuple(q.shape), tuple(k.shape),
            None if bias is None else tuple(bias.shape), False, "BHSD") \
            or (bias is not None and bias.shape[0] != q.shape[0]) \
            or q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError("%s kernel: q %s, bias %s outside S <= 256, S %% "
                         "128 == 0, D in (64, 128), bias [B, 1|H, S, S]"
                         % (kernel, tuple(q.shape), None if bias is None
                            else tuple(bias.shape)))
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)):
        if t is not None and t.stride(3) != 1:
            raise ValueError("%s kernel: %s's head dim is not dense "
                             "(stride %d)" % (kernel, name, t.stride(3)))


def _small_fwd_kernel():
    return _build.function(
        "small_attention", "small_attention_fwd_f32",
        [_VP] * 6 + [_I] * 5 + [ctypes.c_float, ctypes.c_uint,
                                ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                                _VP] + [_LL] * 9 + [_VP])


def _small_fwd_cuda(q, k, v, bias, sm_scale, dropout_prob, seed, seed_out):
    fn = _small_fwd_kernel()
    _small_check("small_attention_fwd", q, k, v, bias)
    if seed_out is not None:
        check_seed_tensor("small_attention_fwd", "seed_out", seed_out,
                          q.device)
    thr = philox.keep_threshold(dropout_prob)
    k0, k1 = philox.seed_words(seed) if seed is not None else (0, 0)
    bb, h, s, d = q.shape
    out = torch.empty((bb, h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bb, h, s, 1), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None, out.data_ptr(),
             lse.data_ptr(), bb, h, s, d,
             0 if bias is None else bias.shape[1], float(sm_scale),
             thr or 0, k0, k1,
             philox.inv_realized_q(thr) if thr is not None else 1.0,
             seed_out.data_ptr() if seed_out is not None else None,
             *strides, stream)
    raise_on_error("small_attention_fwd", err)
    small_attention_fwd.launches += 1
    return out, lse


def small_attention_fwd(q, k, v, bias, sm_scale, dropout_prob, seed,
                        seed_out=None):
    """Small-sequence attention forward -> (out, lse [B, H, S, 1] f32).
    ``seed``: the two key words (on the host); ``seed_out``, an int32 [2]
    on q's device, receives them when given (on the card the kernel
    writes it).  CPU and meta tensors take the plain version."""
    if q.device.type in ("cpu", "meta"):
        out = small_attention_fwd_reference(q, k, v, bias, sm_scale,
                                            dropout_prob, seed)
        if seed_out is not None and q.device.type == "cpu":
            seed_out.copy_(philox.seed_tensor(
                seed if seed is not None else (0, 0)))
        return out
    return _small_fwd_cuda(q, k, v, bias, sm_scale, dropout_prob, seed,
                           seed_out)


small_attention_fwd.launches = 0


def _small_bwd_kernel():
    return _build.function(
        "small_attention_bwd", "small_attention_bwd_f32",
        [_VP] * 10 + [_I] * 5 + [ctypes.c_float, ctypes.c_uint, _VP,
                                 ctypes.c_float, _VP, _VP])


def small_attention_bwd_fused(q, k, v, bias, sm_scale, dropout_prob, seed,
                              do, lse, delta):
    """(dQ, dK, dV) dense [B, H, S, D] by the fused kernel
    (``csrc/small_attention_bwd.cu``) from the forward's lse and delta =
    rowsum(dO . O) (``attention_delta``); CUDA tensors only, counted in
    ``small_attention_bwd.launches``.  The plain version is
    ``small_attention_bwd_reference``."""
    fn = _small_bwd_kernel()
    _small_check("small_attention_bwd", q, k, v, bias, do)
    check_cuda_f32("small_attention_bwd", q.device, lse=lse, delta=delta)
    bb, h, s, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.numel() != bb * h * s:
            raise ValueError("small_attention_bwd kernel: %s %s, want [%d, "
                             "%d, %d, 1]" % (name, tuple(t.shape), bb, h, s))
    thr = philox.keep_threshold(dropout_prob)
    if thr is not None:
        check_seed_tensor("small_attention_bwd", "seed", seed, q.device)
    # the kernel adds each key tile's share of dQ into it
    dq = torch.zeros((bb, h, s, d), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    strides = (ctypes.c_longlong * 12)(
        *[st for t in (q, k, v, do) for st in t.stride()[:3]])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None, do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), bb, h, s, d,
             0 if bias is None else bias.shape[1], float(sm_scale),
             thr or 0, seed.data_ptr() if thr is not None else None,
             philox.inv_realized_q(thr) if thr is not None else 1.0,
             strides, stream)
    raise_on_error("small_attention_bwd", err)
    small_attention_bwd.launches += 1
    return dq, dk, dv


def _small_bwd_cuda(q, k, v, bias, sm_scale, dropout_prob, seed, out, lse,
                    do):
    return small_attention_bwd_fused(q, k, v, bias, sm_scale, dropout_prob,
                                     seed, do, lse, attention_delta(out, do))


def small_attention_bwd_ctas_per_sm(head_dim):
    """CTAs of the small backward kernel an SM holds at once for this head
    width (a report of its occupancy; needs the card)."""
    fn = _build.function("small_attention_bwd",
                         "small_attention_bwd_ctas_per_sm",
                         [_I, ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    raise_on_error("small_attention_bwd", fn(int(head_dim), ctypes.byref(n)))
    return n.value


def small_attention_bwd(q, k, v, bias, sm_scale, dropout_prob, seed, out,
                        lse, do):
    """Small-sequence attention backward -> (dq, dk, dv), dense [B, H, S,
    D].  ``seed`` is the forward's int32 [2] Seed tensor (the kernel reads
    its words on the card; a CPU tensor's path also takes two key words).
    CPU and meta tensors take the plain version; CUDA tensors launch the
    fused kernel of ``csrc/small_attention_bwd.cu`` (the core of
    ``csrc/flash_bwd.cuh`` with the dropout mask) once."""
    if q.device.type in ("cpu", "meta"):
        return small_attention_bwd_reference(q, k, v, bias, sm_scale,
                                             dropout_prob, seed, out, lse,
                                             do)
    return _small_bwd_cuda(q, k, v, bias, sm_scale, dropout_prob, seed, out,
                           lse.contiguous(), do)


small_attention_bwd.launches = 0


class SmallAttention(torch.autograd.Function):
    """Differentiable small-sequence attention with in-kernel dropout
    (the reference's custom-VJP ``small_attention``): forward by
    ``small_attention_fwd``, backward by ``small_attention_bwd`` from the
    saved out, lse and Seed, which re-draws the forward's mask.  The bias
    is a mask and gets no gradient."""

    @staticmethod
    def forward(q, k, v, bias, sm_scale, dropout_prob, seed):
        seed_t = torch.empty(2, dtype=torch.int32, device=q.device)
        out, lse = small_attention_fwd(q, k, v, bias, sm_scale, dropout_prob,
                                       seed, seed_out=seed_t)
        return out, lse, seed_t

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, sm_scale, dropout_prob, _seed = inputs
        out, lse, seed_t = output
        ctx.mark_non_differentiable(lse, seed_t)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed_t)
        ctx.sm_scale, ctx.dropout_prob = sm_scale, dropout_prob

    @staticmethod
    def backward(ctx, dout, _dlse, _dseed):
        q, k, v, bias, out, lse, seed_t = ctx.saved_tensors
        dq, dk, dv = small_attention_bwd(q, k, v, bias, ctx.sm_scale,
                                         ctx.dropout_prob, seed_t, out, lse,
                                         dout)
        return dq, dk, dv, None, None, None, None


def small_attention(q, k, v, bias, sm_scale, dropout_prob, seed):
    """Attention output [B, H, S, D] with in-kernel attention-prob
    dropout, differentiable in q, k and v; ``seed``: two key words."""
    return SmallAttention.apply(q, k, v, bias, sm_scale, dropout_prob,
                                seed)[0]
