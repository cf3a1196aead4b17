// Small-sequence attention with in-kernel dropout for Hopper (sm_90a),
// float32: the forward, on the tensor cores in 3xTF32.
//
// Replaces: paddle_tpu/pallas_kernels/flash_attention.py
// `_small_fwd_kernel` (launched by `small_attention_fwd`), the training
// attention that FLAGS_fused_small_attention routes the flash_attention
// op to.  Same function, for S <= 256, S % 128 == 0, D in {64, 128}:
//
//   s[b,h,i,j] = (q[b,h,i] . k[b,h,j]) * scale + bias[b, h|0, i, j]
//   prob = softmax_j(s),  lse = logsumexp_j(s)                (f32)
//   out  = sum_j (keep ? prob * inv_q : 0) v[b,h,j]
//
// keep = u32 < thr of element ((b * H + h) * S + i) * S + j of the Philox
// stream keyed by the op's two seed words (philox.cuh), thr and inv_q the
// TPU kernel's contract (thr = round((1 - p) 2^32), inv_q = 2^32 / thr);
// thr == 0 means no dropout.  The TPU kernel draws its mask from the
// core's generator seeded per batch block; the port's stream depends on
// the element index alone, so small_attention_bwd.cu re-draws the same
// mask with its own tiling.  Block (0, 0, 0) stores the two seed words to
// the op's Seed output, which the backward reads on the card.
//
// Bound: bytes.  4 B H S^2 D flops (the two products) against the bytes
// of q, k, v, the bias, out and lse; on the f32 SIMT pipes BERT's S =
// 128, D = 64 would be operations-bound (~32 flops a byte against the
// card's ~20 f32 flop/byte ridge), in 3xTF32 on the tensor cores (three
// TF32 products per f32 product at 495 TF/s) it is bytes-bound: at B =
// 32, H = 12, 52.6 MB take 0.0157 ms at 3.35 TB/s, the TF32 products
// 0.0098 ms.  One Philox call per four scores is integer work beside them.
//
// Design: the flash forward's core (flash_fwd.cuh, row 2's kernel) with
// kDrop, in 64-row CTAs of four warps (152 registers, no spill, 3 CTAs an
// SM at D = 64; 210 and one at D = 128): 3xTF32 `mma.sync.m16n8k8`, 32-key
// tiles through a 2-stage cp.async ring, the scores and the online
// softmax in the accumulator fragments.  The keep bits are drawn in
// registers where the scores are, four Philox calls a thread per key
// tile, the two threads that share a Philox group swapping halves by one
// shuffle; the row sum takes the undropped p, the A operand of p . v the
// dropped and upscaled one, so out = (sum_j kept p_j inv_q v_j) / sum_j
// p_j, the reference's (p / l) * inv_q in another rounding order.
// q, k and v are read through (batch, head, row) strides with unit stride
// along D; bias, out and lse are contiguous.
//
// Entry points: plain C, each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include "flash_fwd.cuh"

namespace {

constexpr int kWarps = 4;  // 64-row CTAs (flash_attention.py FWD_DEFAULT_WARPS)

}  // namespace

// thr == 0: no dropout (k0, k1, inv_q unused); seed_out may be null
extern "C" cudaError_t small_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, float* lse, int B, int H, int S, int D, int bias_heads,
    float scale, unsigned int thr, unsigned int k0, unsigned int k1,
    float inv_q, int* seed_out, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || S <= 0 || S > 256 ||
      S % 128 != 0 || (D != 64 && D != 128) ||
      (bias_heads != 0 && bias_heads != 1 && bias_heads != H) ||
      (bias_heads != 0 && bias == nullptr) || !flash_fwd::aligned16(out))
    return cudaErrorInvalidValue;
  flash_fwd::Args a = flash_fwd::make_args(
      q, k, v, bias, out, lse, H, S, S, D, bias_heads, 0, scale, q_sb, q_sh,
      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  a.thr = thr;
  a.k0 = k0;
  a.k1 = k1;
  a.inv_q = inv_q;
  a.seed_out = seed_out;
  return flash_fwd::launch_d<kWarps, true>(a, B, stream);
}

// CTAs of the kernel that takes D resident on one SM at once (for reports)
extern "C" cudaError_t small_attention_fwd_ctas_per_sm(int D, int* n) {
  return flash_fwd::ctas_d<kWarps, true>(D, n);
}
