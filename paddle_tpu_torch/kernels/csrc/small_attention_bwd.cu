// Small-sequence attention with in-kernel dropout for Hopper (sm_90a),
// float32: the backward, as one fused kernel.
//
// Replaces: paddle_tpu/pallas_kernels/flash_attention.py
// `_small_bwd_kernel` (launched by `small_attention_bwd`).  Same function,
// for S <= 256, S % 128 == 0, D in {64, 128}, with s the forward's scores
// (small_attention.cu), lse its row log-sum-exp and delta = rowsum(dO . O)
// (one torch expression, as the reference computes it outside its kernel):
//
//   prob = exp(s - lse)                       recomputed, never stored
//   pd   = keep ? prob * inv_q : 0            the forward's dropped probs
//   dp   = keep ? (dO . v) * inv_q : 0
//   ds   = prob * (dp - delta) * scale
//   dQ = ds @ k,   dK = ds^T @ q,   dV = pd^T @ dO
//
// keep is the forward's mask, re-drawn: u32 < thr of element
// ((b * H + h) * S + i) * S + j of the Philox stream (philox.cuh) keyed by
// the two words of the op's Seed tensor, which every CTA reads from device
// memory (the TPU kernel's scalar prefetch; the host never reads it).
// thr == 0 means no dropout.
//
// Bound: operations.  Five multiply-adds per (i, j, d), one for each of
// s, dO . v, dV, dK and dQ: 10 B H S^2 D flops, plus one Philox call per
// four scores, against the bytes of q, k, v, dO, the bias, lse, delta and
// the three gradients: ~39 flops a byte at BERT's S = 128, D = 64, above
// the card's ~20 f32 flop/byte ridge.  (The two kernels this replaces
// computed s and dP twice, 14 multiply-adds per (i, j, d), and drew the
// mask twice.)
//
// Design: the fused flash backward's core (flash_bwd.cuh) with kSmall:
// one 256-thread CTA per (b, h, 64-key tile) loops over the query tiles,
// computes s^T and dP^T once a tile pair, draws the pair's 64 x 64 keep
// bytes once into shared memory (while the query tile's loads are in
// flight) and applies them where ds is formed, writing pd over p for the
// dV product.  dK and dV stay in registers; dQ is added into a zeroed f32
// dQ by vector reductions, one per key tile: at S = 128 (two key tiles)
// each dQ element is 0 + a + b, bitwise reproducible run to run; at S =
// 256 (four) its last bits may vary between runs.
//
// Entry points: plain C, each returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"

// strides: 12 values, (batch, head, row) of q, k, v and dO in turn; dq
// must hold zeros.  thr == 0: no dropout (seed, inv_q unused); else seed
// points at the op's two int32 seed words on the device.
extern "C" cudaError_t small_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dq,
    float* dk, float* dv, int B, int H, int S, int D, int bias_heads,
    float scale, unsigned int thr, const int* seed, float inv_q,
    const long long* strides, cudaStream_t stream) {
  flash_bwd::Args a =
      flash_bwd::make_args(q, k, v, bias, dout, lse, delta, dq, dk, dv, H, S,
                           S, D, bias_heads, 0, scale, strides);
  a.thr = thr;
  a.seed = seed;
  a.inv_q = inv_q;
  if (!flash_bwd::args_ok(a, B) || S > 256 || S % 128 != 0 ||
      (D != 64 && D != 128) || (thr != 0u && seed == nullptr))
    return cudaErrorInvalidValue;
  return flash_bwd::launch_any<true>(a, B, stream);
}

// CTAs of the kernel that takes D resident on one SM at once (for reports)
extern "C" cudaError_t small_attention_bwd_ctas_per_sm(int D, int* ctas) {
  return flash_bwd::ctas_per_sm<true>(D, ctas);
}
