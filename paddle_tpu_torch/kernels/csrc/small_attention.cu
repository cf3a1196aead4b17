// Small-sequence attention with in-kernel dropout for Hopper (sm_90a),
// float32: the forward.
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
// Bound: operations.  4 B H S^2 D flops (the two products) plus a
// Philox call per four scores, against the bytes of q, k, v, the bias,
// out and lse; at BERT's S = 128, D = 64 that is ~32 flops a byte, above
// the card's ~20 f32 flop/byte ridge, on the f32 SIMT pipes.  Design (the
// flash forward's, flash_attention.cu, plus the mask):
//   * one 256-thread CTA per (b, h, 64-row q tile), looping over 64-column
//     k tiles with the online softmax state (max, sum, accumulator) in f32
//     registers: K and V of a head are never resident at once (at S = 256,
//     D = 128 they would be 256 KB, over the 227 KB a CTA may hold);
//   * per k tile the CTA draws the tile's 64 x 64 keep bytes into shared
//     memory, one Philox call per four neighbouring columns;
//   * thread (rg, cg) owns rows 4rg..4rg+3 and columns cg + 16j of a score
//     tile; the row sum takes the undropped p, the p @ v product the
//     dropped and upscaled one, so out = (sum_j kept p_j inv_q v_j) / sum_j
//     p_j, the reference's (p / l) * inv_q in another rounding order.
// q, k and v are read through (batch, head, row) strides with unit stride
// along D; bias, out and lse are contiguous.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "philox.cuh"

namespace {

constexpr int kB = 64;  // rows of a q tile, columns of a k tile
constexpr int kThreads = 256;
constexpr int ldp = kB + 1;
constexpr float kInit = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Drop {
  uint32_t thr, k0, k1;
  float inv_q;
};

// keep bytes of the kB x kB tile of head `head` at (q0, k0): byte
// [r * kB + c] decides element ((head * S + q0 + r) * S + k0 + c); four
// neighbouring columns share one Philox call (S, k0, c are multiples of 4)
__device__ __forceinline__ void keep_tile(uint8_t* keep, size_t head, int S,
                                          int q0, int k0, const Drop& dp,
                                          int tid) {
  for (int g = tid; g < kB * kB / 4; g += kThreads) {
    const int r = g / (kB / 4);
    const int c = (g - r * (kB / 4)) * 4;
    const unsigned long long e =
        ((unsigned long long)head * S + q0 + r) * S + k0 + c;
    const uint4 w = philox::group(e >> 2, dp.k0, dp.k1);
    uint8_t* o = keep + r * kB + c;
    o[0] = w.x < dp.thr;
    o[1] = w.y < dp.thr;
    o[2] = w.z < dp.thr;
    o[3] = w.w < dp.thr;
  }
}

template <int DC>  // D = 16 * DC, DC in {4, 8}
__global__ void __launch_bounds__(kThreads)
small_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int S, int bias_heads, float scale, Drop dp,
                 int* __restrict__ seed_out, Strides qs, Strides ks,
                 Strides vs) {
  constexpr int D = 16 * DC;
  constexpr int ld = D + 1;  // padded row stride of the q, k tiles
  extern __shared__ float smem[];
  float* sQ = smem;            // kB x ld
  float* sK = sQ + kB * ld;    // kB x ld
  float* sV = sK + kB * ld;    // kB x D
  float* sP = sV + kB * D;     // kB x ldp
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sP + kB * ldp);  // kB x kB

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const size_t head = (size_t)b * H + h;
  if (seed_out != nullptr && blockIdx.x == 0 && h == 0 && b == 0 &&
      tid == 0) {
    seed_out[0] = (int)dp.k0;
    seed_out[1] = (int)dp.k1;
  }

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* bb = nullptr;
  if (bias_heads > 0)
    bb = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) *
                    (size_t)S * S;

  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    sQ[r * ld + d] = qb[(q0 + r) * qs.s + d];
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kInit;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kB * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      sK[r * ld + d] = kb[(k0 + r) * ks.s + d];
      sV[r * D + d] = vb[(k0 + r) * vs.s + d];
    }
    if (dp.thr != 0u) keep_tile(sKeep, head, S, q0, k0, dp, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;  // scale after the dot, as the reference
        if (bb != nullptr) x += bb[(size_t)row * S + k0 + cg + 16 * j];
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const float p = expf(s[i][j] - mx);
        ps += p;
        float pd = p;
        if (dp.thr != 0u)
          pd = sKeep[(rg * 4 + i) * kB + c] ? p * dp.inv_q : 0.f;
        sP[(rg * 4 + i) * ldp + c] = pd;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kB; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[kk * D + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const float L = l[i] == 0.f ? 1.f : l[i];
    float* o = out + (head * S + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[cg + 16 * c] = acc[i][c] / L;
    if (cg == 0) lse[head * S + row] = m[i] + logf(L);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)2 * kB * (D + 1) + (size_t)kB * D +
                          (size_t)kB * ldp) +
         (size_t)kB * kB;
}

// the dynamic shared-memory limit of small_fwd_kernel<DC> is raised once
// per device, so that a launch costs no attribute call
template <int DC>
cudaError_t ensure_smem_limit() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(small_fwd_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(16 * DC));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, float* lse, int B, int H,
                   int S, int bias_heads, float scale, Drop dp, int* seed_out,
                   Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  cudaError_t err = ensure_smem_limit<DC>();
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kB, H, B);
  small_fwd_kernel<DC><<<grid, kThreads, smem_bytes(16 * DC), stream>>>(
      q, k, v, bias, out, lse, H, S, bias_heads, scale, dp, seed_out, qs, ks,
      vs);
  return cudaGetLastError();
}

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
      (bias_heads != 0 && bias == nullptr))
    return cudaErrorInvalidValue;
  const Drop dp{thr, k0, k1, inv_q};
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  if (D == 64)
    return launch<4>(q, k, v, bias, out, lse, B, H, S, bias_heads, scale, dp,
                     seed_out, qs, ks, vs, stream);
  return launch<8>(q, k, v, bias, out, lse, B, H, S, bias_heads, scale, dp,
                   seed_out, qs, ks, vs, stream);
}
