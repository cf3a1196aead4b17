"""Paged decode attention: the plain PyTorch versions and the CUDA kernel.

Counterpart of ``paddle_tpu/pallas_kernels/paged_attention.py``.  The
decode step attends one query token per lane against that lane's KV
history, which lives in fixed-size blocks of a shared pool named by the
lane's block table.

* ``masked_attention`` is the plain core over contiguous K/V.  The
  unpaged reference loop calls it directly, and the paged reference
  gathers the table's blocks and calls it, which keeps paged and unpaged
  decode bitwise-comparable on the CPU.
* ``paged_attention_reference`` is the plain paged version.
* ``paged_attention`` dispatches on where the tensors live: CPU tensors
  take the plain version; any other tensor goes to the hand-written CUDA
  kernel (``csrc/paged_attention.cu``), which is built at first use, or
  the call raises.  There is no fallback from the kernel to the plain
  version.  ``paged_attention.launches`` counts kernel launches.
* ``paged_attention_int8`` is the same attention over int8 pools with
  f32 max-abs scales per (block, position, head).  The reference has no
  kernel for it: it gathers the table's blocks, dequantizes them and
  calls ``masked_attention`` (``paddle_tpu/serving/decode_model.py``
  ``make_paged_step``), which ``paged_attention_int8_reference`` repeats.
  On the card it runs the hand-written kernel beside row 1's in
  ``csrc/paged_attention.cu``, which reads the int8 rows and their scales
  in place; ``paged_attention_int8.launches`` counts its launches.
* ``context_splits`` is the kernels' cut of a lane's context into
  splits of a fixed chunk, from the table width and the card's SM count
  alone: the host never reads ``context_lens``, which would make it
  wait for the card every decode step.
"""

import ctypes
import math

import torch

from . import _build

__all__ = ["masked_attention", "paged_attention_reference", "context_splits",
           "paged_attention", "paged_attention_int8_reference",
           "paged_attention_int8"]

# finite, as in the reference: a fully-masked (idle, context_lens == 0)
# lane softmaxes to a uniform average instead of NaN
_MASK = -1e30


def masked_attention(q, k, v, context_lens):
    """Single-token attention over a contiguous history: q [B, H, D],
    k/v [B, S, H, D], context_lens [B] -> [B, H, D].  Positions at or
    past the context length are masked."""
    d = q.shape[-1]
    # the scale is applied after the dot product, as in the reference
    s = torch.einsum("bhd,bshd->bhs", q, k) * (1.0 / math.sqrt(d))
    pos = torch.arange(k.shape[1], dtype=torch.int32,
                       device=q.device)[None, None, :]
    s = torch.where(pos < context_lens.to(torch.int32)[:, None, None], s,
                    _MASK)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v)


def paged_attention_reference(q, k_cache, v_cache, block_tables,
                              context_lens):
    """Gather the table's blocks into contiguous K/V, then
    ``masked_attention``.  q [B, H, D]; k_cache/v_cache
    [num_blocks, block_size, H, D]; block_tables [B, MAXB] (entries < 0
    are unused slots: they clamp to block 0 and are masked by
    context_lens)."""
    bb, maxb = block_tables.shape
    bs, h, d = k_cache.shape[1:]
    idx = block_tables.to(torch.long).clamp(min=0)
    k = k_cache[idx].reshape(bb, maxb * bs, h, d)
    v = v_cache[idx].reshape(bb, maxb * bs, h, d)
    return masked_attention(q, k, v, context_lens)


def paged_attention_int8_reference(q, k_i8, v_i8, k_scale, v_scale,
                                   block_tables, context_lens):
    """The reference's int8 attention: gather the table's int8 blocks and
    their scales, dequantize (``kv_cache.dequantize_kv``: payload times
    its scale), then ``masked_attention``.  k_i8/v_i8 [num_blocks,
    block_size, H, D] int8; k_scale/v_scale [num_blocks, block_size, H]
    f32."""
    bb, maxb = block_tables.shape
    bs, h, d = k_i8.shape[1:]
    idx = block_tables.to(torch.long).clamp(min=0)
    k = (k_i8[idx].to(torch.float32) * k_scale[idx][..., None]) \
        .reshape(bb, maxb * bs, h, d)
    v = (v_i8[idx].to(torch.float32) * v_scale[idx][..., None]) \
        .reshape(bb, maxb * bs, h, d)
    return masked_attention(q, k, v, context_lens)


_MAX_D = 256
_MAX_TABLE = 8192
_VP, _I = ctypes.c_void_p, ctypes.c_int
# positions a CTA of the kernel walks: 128 at D = 64 is two steps of its
# 8 warps x 8 positions (64 and 256 timed slower at the smoke's decode
# shape on an H100, PERF.md)
CHUNK = 128
_MAX_SPLITS = 1024


def context_splits(width, sm_count):
    """(chunk, splits) of a table ``width`` = MAXB * bs positions wide on a
    card of ``sm_count`` SMs: splits of CHUNK positions, at most one per
    SM for a lane (past that a split takes several chunks), so that the
    scratch of the partials and their merge stay small."""
    s = -(-width // CHUNK)
    chunk = CHUNK * -(-s // max(1, min(sm_count, _MAX_SPLITS)))
    return chunk, -(-width // chunk)


def _kernel():
    return _build.function(
        "paged_attention", "paged_attention_f32",
        [_VP] * 8 + [_I] * 8 + [ctypes.c_float, _VP])


def _kernel_int8():
    return _build.function(
        "paged_attention", "paged_attention_int8",
        [_VP] * 10 + [_I] * 8 + [ctypes.c_float, _VP])


# per (device, stream): the int32 merge counters, zero between launches
_counters = {}


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _counter(device, stream, n):
    """int32 [>= n] counters of ``stream``, zeroed once: the kernel sets
    each back to 0 after its merge.  One buffer a stream, so launches on
    two streams never share a counter."""
    c = _counters.get((device, stream))
    if c is None or c.numel() < n:
        c = _counters[device, stream] = torch.zeros(
            n, dtype=torch.int32, device=device)
    return c


def _check(q, k_cache, v_cache, block_tables, context_lens, scales=None):
    """Raises on what the kernels do not take; ``scales`` (k_scale,
    v_scale) marks the int8 kernel's call."""
    named = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
             "block_tables": block_tables, "context_lens": context_lens}
    if scales is not None:
        named.update(k_scale=scales[0], v_scale=scales[1])
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError("paged_attention kernel: %s is on %s, not a "
                             "CUDA device" % (name, t.device))
        if t.device != q.device:
            raise ValueError("paged_attention kernel: %s is on %s, q on %s"
                             % (name, t.device, q.device))
        if not t.is_contiguous():
            raise ValueError("paged_attention kernel: %s is not contiguous"
                             % name)
    pools = torch.int8 if scales is not None else torch.float32
    for name, want in (("q", torch.float32), ("k_cache", pools),
                       ("v_cache", pools), ("k_scale", torch.float32),
                       ("v_scale", torch.float32)):
        if name in named and named[name].dtype != want:
            raise ValueError("paged_attention kernel: %s is %s, wants %s"
                             % (name, named[name].dtype, want))
    for name in ("block_tables", "context_lens"):
        if named[name].dtype != torch.int32:
            raise ValueError("paged_attention kernel: %s is %s, wants int32"
                             % (name, named[name].dtype))
    if q.dim() != 3 or k_cache.dim() != 4 or block_tables.dim() != 2 \
            or context_lens.dim() != 1:
        raise ValueError("paged_attention kernel: want q [B,H,D], caches "
                         "[NB,bs,H,D], tables [B,MAXB], lens [B]")
    bb, h, d = q.shape
    if tuple(k_cache.shape[2:]) != (h, d) \
            or v_cache.shape != k_cache.shape \
            or block_tables.shape[0] != bb or context_lens.shape[0] != bb:
        raise ValueError(
            "paged_attention kernel: shapes disagree: q %s, k %s, v %s, "
            "tables %s, lens %s" % (tuple(q.shape), tuple(k_cache.shape),
                                   tuple(v_cache.shape),
                                   tuple(block_tables.shape),
                                   tuple(context_lens.shape)))
    if scales is not None and (
            tuple(scales[0].shape) != tuple(k_cache.shape[:3])
            or scales[1].shape != scales[0].shape):
        raise ValueError("paged_attention_int8 kernel: scales %s, %s, want "
                         "%s" % (tuple(scales[0].shape),
                                 tuple(scales[1].shape),
                                 tuple(k_cache.shape[:3])))
    if not 0 < d <= _MAX_D:
        raise ValueError("paged_attention kernel: head_dim %d not in "
                         "[1, %d]" % (d, _MAX_D))
    if min(bb, h, k_cache.shape[0], k_cache.shape[1]) <= 0 \
            or not 0 < block_tables.shape[1] <= _MAX_TABLE or bb > 65535:
        raise ValueError("paged_attention kernel: empty or oversized "
                         "geometry q %s, k %s, tables %s"
                         % (tuple(q.shape), tuple(k_cache.shape),
                            tuple(block_tables.shape)))


def _launch(fn, pools, q, block_tables, context_lens):
    """One launch of ``fn`` over ``pools`` (k, v, and for int8 their
    scales): the split plan, the output, the partials' scratch and the
    merge counters."""
    bb, h, d = q.shape
    nb, bs = pools[0].shape[:2]
    maxb = block_tables.shape[1]
    chunk, splits = context_splits(maxb * bs, _sm_count(q.device))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = count = None
    if splits > 1:
        part = torch.empty(bb * h * splits * (d + 2), dtype=torch.float32,
                           device=q.device)
        # one buffer a stream for both kernels: each sets its counters
        # back to 0, and a stream runs its launches in turn
        count = _counter(q.device, stream, bb * h)
    err = fn(q.data_ptr(), *[p.data_ptr() for p in pools],
             block_tables.data_ptr(), context_lens.data_ptr(),
             out.data_ptr(), part.data_ptr() if part is not None else None,
             count.data_ptr() if count is not None else None, bb, h, d, nb,
             bs, maxb, chunk, splits, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           "cudaError_t %d" % err)
    return out


def _paged_cuda(q, k_cache, v_cache, block_tables, context_lens):
    fn = _kernel()
    _check(q, k_cache, v_cache, block_tables, context_lens)
    out = _launch(fn, (k_cache, v_cache), q, block_tables, context_lens)
    paged_attention.launches += 1
    return out


def _paged_int8_cuda(q, k_i8, v_i8, k_scale, v_scale, block_tables,
                     context_lens):
    fn = _kernel_int8()
    _check(q, k_i8, v_i8, block_tables, context_lens,
           scales=(k_scale, v_scale))
    out = _launch(fn, (k_i8, v_i8, k_scale, v_scale), q, block_tables,
                  context_lens)
    paged_attention_int8.launches += 1
    return out


def paged_attention(q, k_cache, v_cache, block_tables, context_lens):
    """Paged decode attention -> [B, H, D].  CPU tensors take
    ``paged_attention_reference``; CUDA tensors launch the kernel, whose
    idle lanes (context_lens <= 0) come back as zeros where the plain
    version gives a uniform average — both are discarded by the engine."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_cache, v_cache, block_tables,
                                         context_lens)
    return _paged_cuda(q, k_cache, v_cache, block_tables, context_lens)


paged_attention.launches = 0


def paged_attention_int8(q, k_i8, v_i8, k_scale, v_scale, block_tables,
                         context_lens):
    """Paged decode attention over int8 pools -> [B, H, D] f32.  CPU
    tensors take ``paged_attention_int8_reference``; CUDA tensors launch
    the int8 kernel, which applies each position's K scale to its q.k dot
    product and its V scale to its probability weight (the reference
    dequantizes first), and whose idle lanes come back as zeros, as row
    1's do."""
    if q.device.type == "cpu":
        return paged_attention_int8_reference(q, k_i8, v_i8, k_scale,
                                              v_scale, block_tables,
                                              context_lens)
    return _paged_int8_cuda(q, k_i8, v_i8, k_scale, v_scale, block_tables,
                            context_lens)


paged_attention_int8.launches = 0
