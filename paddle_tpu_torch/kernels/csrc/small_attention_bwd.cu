// Small-sequence attention with in-kernel dropout for Hopper (sm_90a),
// float32: the backward, as two kernels.
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
// Bound: operations.  dQ does 6 and dK/dV 8 multiply-adds per (i, j, d),
// 28 B H S^2 D flops, plus a Philox call per four scores in each kernel,
// against the bytes of q, k, v, dO, the bias, lse, delta and the three
// gradients: ~60 flops a byte at BERT's S = 128, D = 64, above the card's
// ~20 f32 flop/byte ridge.  Design: the flash backward's split
// (flash_attention_bwd.cu), so neither kernel needs atomics, and each
// re-draws the mask of the tiles it visits:
//   * dQ: one 256-thread CTA per (b, h, 64-row q tile), looping over
//     64-column k tiles;
//   * dK/dV: one CTA per (b, h, 64-row k tile), looping over 64-row q
//     tiles;
//   * per tile pair the CTA draws the 64 x 64 keep bytes into shared
//     memory, one Philox call per four neighbouring key columns, as the
//     forward does; every tile is read once per CTA into shared memory,
//     rows padded by one float; thread (rg, cg) owns a 4 x 4 block of the
//     score tile, then 4 rows x D / 16 columns of its gradient.
// q, k, v and dO are read through (batch, head, row) strides with unit
// stride along D; bias, lse, delta and the gradients are contiguous.
//
// Entry point: plain C, launches both kernels and returns the first
// launch error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "philox.cuh"

namespace {

constexpr int kB = 64;  // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int ldp = kB + 1;

struct Strides {
  long long b, h, s;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, S, bias_heads;
  float scale;
  uint32_t thr;
  const int* seed;
  float inv_q;
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ const float* head_bias(const Args& a, int b,
                                                  int h) {
  if (a.bias_heads == 0) return nullptr;
  return a.bias + ((size_t)b * a.bias_heads + (a.bias_heads > 1 ? h : 0)) *
                      (size_t)a.S * a.S;
}

// rows [r0, r0 + kB) of a strided [S, D] head into a padded tile
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int tid) {
  constexpr int ld = D + 1;
  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = src[(r0 + r) * row_stride + d];
  }
}

// keep bytes of the kB x kB tile at (q0, k0) of head `head`: byte
// [r * kB + c] decides element ((head * S + q0 + r) * S + k0 + c), as the
// forward (small_attention.cu) draws it
__device__ __forceinline__ void keep_tile(uint8_t* keep, size_t head, int S,
                                          int q0, int k0, uint32_t thr,
                                          uint32_t k0w, uint32_t k1w,
                                          int tid) {
  for (int g = tid; g < kB * kB / 4; g += kThreads) {
    const int r = g / (kB / 4);
    const int c = (g - r * (kB / 4)) * 4;
    const unsigned long long e =
        ((unsigned long long)head * S + q0 + r) * S + k0 + c;
    const uint4 w = philox::group(e >> 2, k0w, k1w);
    uint8_t* o = keep + r * kB + c;
    o[0] = w.x < thr;
    o[1] = w.y < thr;
    o[2] = w.z < thr;
    o[3] = w.w < thr;
  }
}

template <int DC>  // D = 16 * DC, DC in {4, 8}
__global__ void __launch_bounds__(kThreads) small_bwd_dq_kernel(Args a) {
  constexpr int D = 16 * DC;
  constexpr int ld = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;          // kB x ld
  float* sO = sQ + kB * ld;  // dO tile
  float* sK = sO + kB * ld;
  float* sV = sK + kB * ld;
  float* sS = sV + kB * ld;  // ds, kB x ldp
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sS + kB * ldp);

  const int S = a.S;
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const size_t head = (size_t)b * a.H + h;
  const float* bb = head_bias(a, b, h);
  const bool drop = a.thr != 0u;
  const uint32_t k0w = drop ? (uint32_t)a.seed[0] : 0u;
  const uint32_t k1w = drop ? (uint32_t)a.seed[1] : 0u;

  load_tile<D>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, tid);
  load_tile<D>(sO, a.dout + b * a.os.b + h * a.os.h, a.os.s, q0, tid);
  float lr[4], dl[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    lr[i] = a.lse[head * S + row];
    dl[i] = a.delta[head * S + row];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  for (int k0 = 0; k0 < S; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, kb, a.ks.s, k0, tid);
    load_tile<D>(sV, vb, a.vs.s, k0, tid);
    if (drop) keep_tile(sKeep, head, S, q0, k0, a.thr, k0w, k1w, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(rg * 4 + i) * ld + d];
        ov[i] = sO[(rg * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(cg + 16 * j) * ld + d];
        vv[j] = sV[(cg + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        float x = s[i][j] * a.scale;  // scale after the dot, as forward
        if (bb != nullptr) x += bb[(size_t)row * S + k0 + c];
        const float p = expf(x - lr[i]);
        float dpv = dp[i][j];
        if (drop) dpv = sKeep[(rg * 4 + i) * kB + c] ? dpv * a.inv_q : 0.f;
        sS[(rg * 4 + i) * ldp + c] = p * (dpv - dl[i]) * a.scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kB; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(rg * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kvv = sK[kk * ld + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += dsv[i] * kvv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = a.dq + (head * S + q0 + rg * 4 + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[cg + 16 * c] = acc[i][c];
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads) small_bwd_dkv_kernel(Args a) {
  constexpr int D = 16 * DC;
  constexpr int ld = D + 1;
  extern __shared__ float smem[];
  float* sK = smem;           // kB x ld
  float* sV = sK + kB * ld;
  float* sQ = sV + kB * ld;
  float* sO = sQ + kB * ld;   // dO tile
  float* sP = sO + kB * ld;   // pd^T, kB (k rows) x ldp (q columns)
  float* sS = sP + kB * ldp;  // ds^T
  float* sL = sS + kB * ldp;  // lse of the q tile's rows
  float* sD = sL + kB;        // delta of the q tile's rows
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sD + kB);  // [q][k] bytes

  const int S = a.S;
  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // k rows 4rg .. 4rg+3 of the tile
  const int cg = tid & 15;  // q columns cg + 16j
  const size_t head = (size_t)b * a.H + h;
  const float* bb = head_bias(a, b, h);
  const bool drop = a.thr != 0u;
  const uint32_t k0w = drop ? (uint32_t)a.seed[0] : 0u;
  const uint32_t k1w = drop ? (uint32_t)a.seed[1] : 0u;

  load_tile<D>(sK, a.k + b * a.ks.b + h * a.ks.h, a.ks.s, k0, tid);
  load_tile<D>(sV, a.v + b * a.vs.b + h * a.vs.h, a.vs.s, k0, tid);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* ob = a.dout + b * a.os.b + h * a.os.h;
  for (int q0 = 0; q0 < S; q0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sQ, qb, a.qs.s, q0, tid);
    load_tile<D>(sO, ob, a.os.s, q0, tid);
    if (tid < kB) {
      sL[tid] = a.lse[head * S + q0 + tid];
      sD[tid] = a.delta[head * S + q0 + tid];
    }
    if (drop) keep_tile(sKeep, head, S, q0, k0, a.thr, k0w, k1w, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(rg * 4 + i) * ld + d];
        vv[i] = sV[(rg * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(cg + 16 * j) * ld + d];
        ov[j] = sO[(cg + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[j] * kv[i];
          dp[i][j] += ov[j] * vv[i];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = cg + 16 * j;
        float x = s[i][j] * a.scale;
        if (bb != nullptr) x += bb[(size_t)(q0 + qc) * S + k0 + kl];
        const float p = expf(x - sL[qc]);
        float pd = p, dpv = dp[i][j];
        if (drop) {
          const bool keep = sKeep[qc * kB + kl] != 0;
          pd = keep ? p * a.inv_q : 0.f;
          dpv = keep ? dpv * a.inv_q : 0.f;
        }
        sP[kl * ldp + qc] = pd;
        sS[kl * ldp + qc] = p * (dpv - sD[qc]) * a.scale;
      }
    }
    __syncthreads();

    for (int qq = 0; qq < kB; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(rg * 4 + i) * ldp + qq];
        dsv[i] = sS[(rg * 4 + i) * ldp + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = cg + 16 * c;
        const float ov = sO[qq * ld + d];
        const float qv = sQ[qq * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] += pv[i] * ov;
          dk[i][c] += dsv[i] * qv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t krow = head * S + k0 + rg * 4 + i;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = cg + 16 * c;
      a.dk[krow * D + d] = dk[i][c];
      a.dv[krow * D + d] = dv[i][c];
    }
  }
}

constexpr size_t dq_smem(int D) {
  return sizeof(float) * ((size_t)4 * kB * (D + 1) + (size_t)kB * ldp) +
         (size_t)kB * kB;
}

constexpr size_t dkv_smem(int D) {
  return sizeof(float) *
             ((size_t)4 * kB * (D + 1) + (size_t)2 * kB * ldp + 2 * kB) +
         (size_t)kB * kB;
}

// each kernel's dynamic shared-memory limit is raised once per device
template <typename Kernel>
cudaError_t ensure_smem_limit(Kernel kernel, size_t bytes,
                              std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DC>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done_dq{0}, done_dkv{0};
  cudaError_t err =
      ensure_smem_limit(small_bwd_dq_kernel<DC>, dq_smem(16 * DC), done_dq);
  if (err != cudaSuccess) return err;
  err = ensure_smem_limit(small_bwd_dkv_kernel<DC>, dkv_smem(16 * DC),
                          done_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kB, a.H, B);
  small_bwd_dq_kernel<DC><<<grid, kThreads, dq_smem(16 * DC), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  small_bwd_dkv_kernel<DC><<<grid, kThreads, dkv_smem(16 * DC), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 values, (batch, head, row) of q, k, v and dO in turn.
// thr == 0: no dropout (seed, inv_q unused); else seed points at the
// op's two int32 seed words on the device.
extern "C" cudaError_t small_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dq,
    float* dk, float* dv, int B, int H, int S, int D, int bias_heads,
    float scale, unsigned int thr, const int* seed, float inv_q,
    const long long* strides, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || S <= 0 || S > 256 ||
      S % 128 != 0 || (D != 64 && D != 128) ||
      (bias_heads != 0 && bias_heads != 1 && bias_heads != H) ||
      (bias_heads != 0 && bias == nullptr) || dq == nullptr ||
      dk == nullptr || dv == nullptr || (thr != 0u && seed == nullptr))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.S = S;
  a.bias_heads = bias_heads;
  a.scale = scale;
  a.thr = thr;
  a.seed = seed;
  a.inv_q = inv_q;
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.os = Strides{strides[9], strides[10], strides[11]};
  if (D == 64) return launch<4>(a, B, stream);
  return launch<8>(a, B, stream);
}
