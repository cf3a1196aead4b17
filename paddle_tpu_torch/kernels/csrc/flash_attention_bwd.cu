// Flash attention backward for Hopper (sm_90a), float32: one fused kernel
// that computes dQ, dK and dV in a single pass over the score tiles.
//
// Replaces: paddle_tpu/pallas_kernels/flash_attention.py `_bwd_dq_kernel`
// (:112) and `_bwd_dkv_kernel` (:157), both launched by `_bwd_pallas`
// (:332).  Same function: with s = (q . k) * scale + bias, s = -1e30 where
// causal and j > i (the forward's masking, flash_attention.cu), lse the
// forward's row log-sum-exp and delta = rowsum(dO * O) (one torch
// expression, as the reference computes it outside its kernels):
//
//   p  = exp(s - lse)                  recomputed, never stored
//   ds = p * (dO . v - delta) * scale
//   dQ = ds @ k,   dK = ds^T @ q,   dV = p^T @ dO
//
// A fully masked row (every s at the finite -1e30) has lse = -1e30 in f32,
// where -1e30 + log(Sk) is not representable, so exp(s - lse) is 1 for
// every column; the forward averaged V over that row, and p is scaled by
// 1 / Sk there (lse < -1e29) to match it.
//
// Bound: operations.  Five multiply-adds per (i, j, d), one for each of
// s, dO . v, dV, dK and dQ: 10 * B*H*Sq*Sk*D flops (causal: the computed
// half), against the bytes of q, k, v, dO, bias, lse, delta and the three
// gradients.  At BERT's B = 32, H = 12, S = 128, D = 64 that is 4.03
// GFLOP, 0.060 ms at 67 TF/s f32, against 0.027 ms for its 91 MB at
// 3.35 TB/s.  The target is SDPA's whole backward on the same inputs.
//
// Design: the core in flash_bwd.cuh (shared with the small-sequence
// backward, small_attention_bwd.cu), instantiated without the dropout
// mask.  One 256-thread CTA per (b, h, 64-key tile) loops over the query
// tiles; s^T and dP^T are computed once a tile pair, dK and dV stay in
// registers, dQ is added into a zeroed f32 dQ by vector reductions.  With
// at most two key tiles (Sk <= 128, BERT's case) each dQ element is 0 + a
// + b, so dQ is bitwise reproducible run to run; with more key tiles its
// last bits may vary between runs.
// q, k, v and dO are read through (batch, head, row) strides with unit
// stride along D, so the head-split transposes need no copy; bias, lse,
// delta and the gradients are contiguous.
//
// Entry points: plain C; the launch returns its cudaError_t.

#include <cuda_runtime.h>

#include "flash_bwd.cuh"

// strides: 12 values, (batch, head, row) of q, k, v and dO in turn; dq
// must hold zeros
extern "C" cudaError_t flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dq,
    float* dk, float* dv, int B, int H, int Sq, int Sk, int D,
    int bias_heads, int causal, float scale, const long long* st,
    cudaStream_t stream) {
  const flash_bwd::Args a =
      flash_bwd::make_args(q, k, v, bias, dout, lse, delta, dq, dk, dv, H,
                           Sq, Sk, D, bias_heads, causal, scale, st);
  if (!flash_bwd::args_ok(a, B)) return cudaErrorInvalidValue;
  return flash_bwd::launch_any<false>(a, B, stream);
}

// CTAs of the kernel that takes D resident on one SM at once (for reports)
extern "C" cudaError_t flash_attention_bwd_ctas_per_sm(int D, int* ctas) {
  return flash_bwd::ctas_per_sm<false>(D, ctas);
}
