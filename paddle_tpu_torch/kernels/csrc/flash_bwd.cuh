// The fused attention backward core, float32, shared by two entry points:
//
//   * flash_attention_bwd.cu (rows 3 and 4): the flash backward, causal
//     or not, any Sq and Sk, the fully-masked-row rule of the forward;
//   * small_attention_bwd.cu (row 6): the small-sequence backward with
//     the forward's attention-prob dropout re-drawn (kSmall).
//
// One kernel computes dQ, dK and dV in a single pass over the score
// tiles.  With s = (q . k) * scale + bias (s = -1e30 where causal and
// j > i), lse the forward's row log-sum-exp and delta = rowsum(dO * O):
//
//   p  = exp(s - lse)                      recomputed, never stored
//   pd = keep ? p * inv_q : 0              kSmall with dropout; else p
//   dp = keep ? (dO . v) * inv_q : 0       kSmall with dropout; else dO . v
//   ds = p * (dp - delta) * scale
//   dQ = ds @ k,   dK = ds^T @ q,   dV = pd^T @ dO
//
// keep (kSmall, thr != 0) is the forward's mask, re-drawn: u32 < thr of
// element ((b * H + h) * Sq + i) * Sk + j of the Philox stream
// (philox.cuh) keyed by the two words of the op's Seed tensor, which
// every CTA reads from device memory (the host never reads it).
//
// Without kSmall a fully masked row (every s at the finite -1e30) has
// lse = -1e30 in f32, where -1e30 + log(Sk) is not representable, so
// exp(s - lse) is 1 for every column; the forward averaged V over that
// row, and p is scaled by 1 / Sk there (lse < -1e29) to match it.  The
// small kernels' reference takes exp(s - lse) as it is, and so does
// kSmall.
//
// Design (f32 FMA on the SIMT pipes; the tensor cores only as 3xTF32,
// a later step):
//   * one 256-thread CTA per (b, h, 64-key tile).  Its K and V tiles stay
//     in shared memory; it loops over 64-row query tiles (under causal
//     from the diagonal on), and dK and dV accumulate in registers over
//     the whole loop;
//   * per query tile, s^T and dP^T are computed once: warps 0-3 compute
//     the 64 x 64 tile of s^T (K against Q), warps 4-7 that of dP^T (V
//     against dO), each thread an 8 x 4 block, the operands read as
//     16-byte shared loads along D (rows padded by 4 floats, so the
//     loads of a quarter-warp fall in distinct banks): 8 FMAs per load
//     instruction and 4 per float read, so the FMA pipe, not shared
//     memory, is the limit.  p goes to shared memory (written over the
//     bias tile it was computed from), then ds beside it;
//   * kSmall: the tile pair's 64 x 64 keep bytes are drawn once, one
//     Philox call per four neighbouring keys, into shared memory (4 KB,
//     rows padded to 68 bytes so a warp's byte reads fall in distinct
//     banks), while the query tile's loads are in flight.  The warps that
//     compute ds read p and the keep byte of each score they own, and
//     write pd over p for the dV product; so the mask is drawn once per
//     tile pair and applied where the scores are, at no extra pass;
//   * dV += pd^T dO (warps 0-3) and dK += ds^T q (warps 4-7), each thread
//     8 keys x 4 (or 8) columns of one of them;
//   * dQ(query tile) += ds K over the 64 keys, all 256 threads, each 4
//     rows x 4 (or 8) columns, added into an f32 dQ that the wrapper
//     zeroes, with one vector reduction (red.global.add.v4.f32) for 4
//     columns;
//   * loads are cp.async, zero-filled past the tile's edge: once Q, dO
//     and the p tile are consumed, the next query tile's Q, dO, bias,
//     lse and delta are issued and arrive while the dQ product and its
//     reductions run.  A second set of buffers would need ~155 KB a CTA
//     at D = 64 and allow one CTA an SM; with one set a CTA takes 103 KB
//     (107 KB with the keep bytes) and two CTAs fit an SM (at most 128
//     registers a thread, __launch_bounds__(256, 2)), so each hides the
//     other's loads too.  D in (64, 128] takes 167 KB, one CTA an SM;
//   * determinism: dK and dV are summed in one fixed order inside their
//     CTA.  dQ gets one addition per key tile, in the order the CTAs
//     reach it.  With at most two key tiles (Sk <= 128, BERT's case) each
//     dQ element is 0 + a + b, and two-term float addition commutes, so
//     dQ is bitwise reproducible run to run; with more key tiles (the
//     small kernel's S = 256) its last bits may vary between runs.
// q, k, v and dO are read through (batch, head, row) strides with unit
// stride along D, so the head-split transposes need no copy; bias, lse,
// delta and the gradients are contiguous.  Operands that are not 16-byte
// aligned (D or a row stride not a multiple of 4 floats) take 4-byte
// copies; the arithmetic is the same.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace flash_bwd {

constexpr int kB = 64;  // rows of a key tile and of a query tile
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr float kMask = -1e30f;
constexpr float kMaskedRow = -1e29f;  // lse below this: a fully masked row
constexpr int ldp = kB + 4;           // row stride of the bias / p / ds tiles
constexpr int kKeepLd = kB + 4;       // row stride (bytes) of the keep tile

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
  float* dq;  // zeroed by the caller: the kernel adds into it
  float* dk;
  float* dv;
  int H, Sq, Sk, D, bias_heads, causal;
  int vec_in;    // q, k, v, dO: 16-byte copies
  int vec_bias;  // bias: 16-byte copies
  float scale;
  uint32_t thr;     // kSmall: keep iff u32 < thr; 0: no dropout
  const int* seed;  // kSmall with thr != 0: the two key words, on the card
  float inv_q;      // kSmall: kept values times this
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ const float* head_bias(const Args& a, int b,
                                                  int h) {
  if (a.bias_heads == 0) return nullptr;
  return a.bias + ((size_t)b * a.bias_heads + (a.bias_heads > 1 ? h : 0)) *
                      (size_t)a.Sq * a.Sk;
}

// p of score x in a row whose lse is lr (see the masked-row note above)
template <bool kSmall>
__device__ __forceinline__ float prob(float x, float lr, float inv_sk) {
  const float p = expf(x - lr);
  if (kSmall) return p;
  return lr < kMaskedRow ? p * inv_sk : p;
}

// rows [r0, r0 + kB) x columns [0, W) of a strided source (columns at or
// past ncols and rows at or past nrows read as 0) into a tile of row
// stride ld; vec: 16-byte copies (ncols and the row stride multiples of
// 4, the source 16-byte aligned)
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src,
                                          long long row_stride, int r0,
                                          int nrows, int ncols, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int kChunks = W / 4;
    for (int c = tid; c < kB * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      const bool in = r0 + r < nrows && col < ncols;
      cp_async16(dst + r * ld + col,
                 in ? src + (r0 + r) * row_stride + col : src, in);
    }
  } else {
    for (int c = tid; c < kB * W; c += kThreads) {
      const int r = c / W, col = c % W;
      const bool in = r0 + r < nrows && col < ncols;
      cp_async4(dst + r * ld + col,
                in ? src + (r0 + r) * row_stride + col : src, in);
    }
  }
}

// keep bytes of the kB x kB tile at (q0, k0) of head `head`: byte
// [r * kKeepLd + c] decides element ((head * Sq + q0 + r) * Sk + k0 + c),
// as the forward (small_attention.cu) draws it; four bytes a Philox call,
// stored as one word
__device__ __forceinline__ void keep_tile(uint8_t* keep, size_t head, int Sq,
                                          int Sk, int q0, int k0,
                                          uint32_t thr, uint32_t w0,
                                          uint32_t w1, int tid) {
  for (int g = tid; g < kB * kB / 4; g += kThreads) {
    const int r = g / (kB / 4);
    const int c = (g - r * (kB / 4)) * 4;
    const unsigned long long e =
        ((unsigned long long)head * Sq + q0 + r) * Sk + k0 + c;
    const uint4 w = philox::group(e >> 2, w0, w1);
    *reinterpret_cast<uint32_t*>(keep + r * kKeepLd + c) =
        (uint32_t)(w.x < thr) | (uint32_t)(w.y < thr) << 8 |
        (uint32_t)(w.z < thr) << 16 | (uint32_t)(w.w < thr) << 24;
  }
}

__device__ __forceinline__ void red_add4(float* p, float x, float y, float z,
                                         float w) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(x, y, z, w));
}

template <int DW, bool kSmall>
constexpr size_t smem_bytes() {
  // K, V, Q, dO tiles; the bias / p and ds tiles; lse and delta; kSmall:
  // the keep bytes
  return sizeof(float) *
             ((size_t)4 * kB * (DW + 4) + (size_t)2 * kB * ldp + 2 * kB) +
         (kSmall ? (size_t)kB * kKeepLd : 0);
}

// DW: the padded head width (64 or 128); MINB: CTAs an SM; kSmall: the
// small-sequence contract (the dropout mask, no masked-row rule)
template <int DW, int MINB, bool kSmall>
__global__ void __launch_bounds__(kThreads, MINB) flash_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = DW + 4;
  constexpr int NC = DW / 64;  // 4-column chunks a thread owns in dK/dV/dQ
  float* sK = smem;
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sO = sQ + kB * LD;
  float* sP = sO + kB * LD;  // bias tile, then p (then pd): [query][key]
  float* sS = sP + kB * ldp;  // ds: [query][key]
  float* sL = sS + kB * ldp;  // lse of the query tile's rows
  float* sDl = sL + kB;       // delta of the query tile's rows
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sDl + kB);  // kSmall

  const int D = a.D, Sq = a.Sq, Sk = a.Sk;
  const int Dp = (D + 3) & ~3;
  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int half = tid >> 7;  // warps 0-3: s / dV; warps 4-7: dP / dK
  const int g = (tid & 127) >> 4;
  const int l = tid & 15;
  const size_t head = (size_t)b * a.H + h;
  const float* bb = head_bias(a, b, h);
  const float inv_sk = 1.f / (float)Sk;
  const bool vec = a.vec_in != 0;
  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* ob = a.dout + b * a.os.b + h * a.os.h;
  const bool drop = kSmall && a.thr != 0u;
  const uint32_t w0 = drop ? (uint32_t)a.seed[0] : 0u;
  const uint32_t w1 = drop ? (uint32_t)a.seed[1] : 0u;

  load_tile<DW>(sK, LD, a.k + b * a.ks.b + h * a.ks.h, a.ks.s, k0, Sk, D,
                vec, tid);
  load_tile<DW>(sV, LD, a.v + b * a.vs.b + h * a.vs.h, a.vs.s, k0, Sk, D,
                vec, tid);
  // the query tile's Q, dO, bias, lse and delta
  auto load_q = [&](int q0) {
    load_tile<DW>(sQ, LD, qb, a.qs.s, q0, Sq, D, vec, tid);
    load_tile<DW>(sO, LD, ob, a.os.s, q0, Sq, D, vec, tid);
    if (bb != nullptr)
      load_tile<kB>(sP, ldp, bb + k0, Sk, q0, Sq, Sk - k0, a.vec_bias != 0,
                    tid);
    if (tid < 2 * kB) {
      const int r = tid & (kB - 1);
      const float* src = (tid < kB ? a.lse : a.delta) + head * Sq;
      const bool in = q0 + r < Sq;
      cp_async4((tid < kB ? sL : sDl) + r, in ? src + q0 + r : src, in);
    }
  };

  const int nqt = (Sq + kB - 1) / kB;
  // causal: q rows before k0 see none of this tile's keys
  const int qt0 = a.causal ? k0 / kB : 0;
  if (qt0 < nqt) load_q(qt0 * kB);

  float acc[8][4 * NC];  // dV (warps 0-3) or dK (warps 4-7)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * kB;
    const int qvalid = min(kB, Sq - q0);
    // the keep bytes, while the tile's loads are in flight (the previous
    // tile's readers passed two barriers since)
    if (drop) keep_tile(sKeep, head, Sq, Sk, q0, k0, a.thr, w0, w1, tid);
    cp_async_wait_all();
    __syncthreads();

    // s^T (K . Q) or dP^T (V . dO): keys g + 8i, queries l + 16j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    {
      const float* A = half ? sV : sK;
      const float* B = half ? sO : sQ;
#pragma unroll 2
      for (int d = 0; d < Dp; d += 4) {
        float4 bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(B + (l + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 av =
              *reinterpret_cast<const float4*>(A + (g + 8 * i) * LD + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(av.x, bv[j].x, s[i][j]);
            s[i][j] = fmaf(av.y, bv[j].y, s[i][j]);
            s[i][j] = fmaf(av.z, bv[j].z, s[i][j]);
            s[i][j] = fmaf(av.w, bv[j].w, s[i][j]);
          }
        }
      }
    }
    if (half == 0) {  // p, over the bias it reads
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kk = g + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = l + 16 * j;
          float p = 0.f;
          if (k0 + kk < Sk && qq < qvalid) {
            float x = s[i][j] * a.scale;  // scale after the dot, as forward
            if (bb != nullptr) x += sP[qq * ldp + kk];
            if (a.causal && k0 + kk > q0 + qq) x = kMask;
            p = prob<kSmall>(x, sL[qq], inv_sk);
          }
          sP[qq * ldp + kk] = p;
        }
      }
    }
    __syncthreads();
    if (half == 1) {  // ds from p and dP; kSmall: pd over p
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kk = g + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = l + 16 * j;
          float ds = 0.f;
          if (k0 + kk < Sk && qq < qvalid) {
            const float p = sP[qq * ldp + kk];
            float dpv = s[i][j];
            if (drop) {
              const bool keep = sKeep[qq * kKeepLd + kk] != 0;
              dpv = keep ? dpv * a.inv_q : 0.f;
              sP[qq * ldp + kk] = keep ? p * a.inv_q : 0.f;
            }
            ds = p * (dpv - sDl[qq]) * a.scale;
          }
          sS[qq * ldp + kk] = ds;
        }
      }
    }
    __syncthreads();

    // dV += pd^T dO (warps 0-3), dK += ds^T Q (warps 4-7): keys 8g + i,
    // columns 4l + 64c
    {
      const float* A = half ? sS : sP;
      const float* B = half ? sQ : sO;
#pragma unroll 4
      for (int qq = 0; qq < qvalid; ++qq) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(A + qq * ldp + 8 * g);
        const float4 a1 =
            *reinterpret_cast<const float4*>(A + qq * ldp + 8 * g + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 bv = *reinterpret_cast<const float4*>(
              B + qq * LD + 4 * l + 64 * c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * c + 0] = fmaf(av[i], bv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(av[i], bv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(av[i], bv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(av[i], bv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // Q, dO, p, lse and delta are free
    if (qt + 1 < nqt) load_q(q0 + kB);

    // dQ(tile) += ds K: rows 4r + i, columns 4l + 64c, over the keys
    {
      const int r = tid >> 4;
      const int kend = (min(kB, Sk - k0) + 3) & ~3;  // ds and K are 0 past Sk
      float dq[4][4 * NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) dq[i][c] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kend; kk += 4) {
        float dsv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 t =
              *reinterpret_cast<const float4*>(sS + (4 * r + i) * ldp + kk);
          dsv[i][0] = t.x;
          dsv[i][1] = t.y;
          dsv[i][2] = t.z;
          dsv[i][3] = t.w;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 kv = *reinterpret_cast<const float4*>(
                sK + (kk + x) * LD + 4 * l + 64 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dq[i][4 * c + 0] = fmaf(dsv[i][x], kv.x, dq[i][4 * c + 0]);
              dq[i][4 * c + 1] = fmaf(dsv[i][x], kv.y, dq[i][4 * c + 1]);
              dq[i][4 * c + 2] = fmaf(dsv[i][x], kv.z, dq[i][4 * c + 2]);
              dq[i][4 * c + 3] = fmaf(dsv[i][x], kv.w, dq[i][4 * c + 3]);
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * r + i;
        if (row >= Sq) continue;
        float* o = a.dq + (head * Sq + row) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = 4 * l + 64 * c;
          if (d >= D) continue;
          if ((D & 3) == 0) {
            red_add4(o + d, dq[i][4 * c], dq[i][4 * c + 1], dq[i][4 * c + 2],
                     dq[i][4 * c + 3]);
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (d + x < D) atomicAdd(o + d + x, dq[i][4 * c + x]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // K and V, when no query tile sees this key tile

  float* out = half ? a.dk : a.dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * g + i;
    if (key >= Sk) continue;
    float* o = out + (head * Sk + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * l + 64 * c;
      if (d >= D) continue;
      if ((D & 3) == 0) {
        *reinterpret_cast<float4*>(o + d) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                        acc[i][4 * c + 3]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (d + x < D) o[d + x] = acc[i][4 * c + x];
      }
    }
  }
}

// The dynamic shared-memory limit and the carveout (all of the SM's 228 KB
// to shared memory, so that two 107 KB CTAs fit) are set once per device
// and instantiation, so that a launch costs no attribute call.
template <int DW, int MINB, bool kSmall>
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(flash_bwd_kernel<DW, MINB, kSmall>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<DW, kSmall>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_kernel<DW, MINB, kSmall>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DW, int MINB, bool kSmall>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = prepare<DW, MINB, kSmall>();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<DW, kSmall>();
  const dim3 grid((a.Sk + kB - 1) / kB, a.H, B);
  flash_bwd_kernel<DW, MINB, kSmall><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// one launch at D <= 64 (two CTAs an SM) or D <= 128 (one)
template <bool kSmall>
cudaError_t launch_any(const Args& a, int B, cudaStream_t stream) {
  return a.D <= 64 ? launch<64, 2, kSmall>(a, B, stream)
                   : launch<128, 1, kSmall>(a, B, stream);
}

// CTAs of the instantiation that takes D resident on one SM at once
template <bool kSmall>
cudaError_t ctas_per_sm(int D, int* ctas) {
  cudaError_t err =
      D <= 64 ? prepare<64, 2, kSmall>() : prepare<128, 1, kSmall>();
  if (err != cudaSuccess) return err;
  return D <= 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       ctas, flash_bwd_kernel<64, 2, kSmall>, kThreads,
                       smem_bytes<64, kSmall>())
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       ctas, flash_bwd_kernel<128, 1, kSmall>, kThreads,
                       smem_bytes<128, kSmall>());
}

inline bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// Args from the entry points' common arguments; strides: 12 values,
// (batch, head, row) of q, k, v and dO in turn
inline Args make_args(const float* q, const float* k, const float* v,
                      const float* bias, const float* dout, const float* lse,
                      const float* delta, float* dq, float* dk, float* dv,
                      int H, int Sq, int Sk, int D, int bias_heads,
                      int causal, float scale, const long long* st) {
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
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.bias_heads = bias_heads;
  a.causal = causal;
  a.scale = scale;
  a.thr = 0u;
  a.seed = nullptr;
  a.inv_q = 1.f;
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.os = Strides{st[9], st[10], st[11]};
  bool vec = D % 4 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 4 == 0;
  a.vec_in = vec && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(dout);
  a.vec_bias = bias != nullptr && Sk % 4 == 0 && aligned16(bias);
  return a;
}

// the geometry and outputs every launch needs
inline bool args_ok(const Args& a, int B) {
  return B > 0 && a.H > 0 && a.Sq > 0 && a.Sk > 0 && a.D > 0 &&
         a.D <= kMaxD && B <= 65535 && a.H <= 65535 &&
         (a.bias_heads == 0 || a.bias_heads == 1 || a.bias_heads == a.H) &&
         (a.bias_heads == 0 || a.bias != nullptr) && a.dq != nullptr &&
         a.dk != nullptr && a.dv != nullptr && aligned16(a.dq) &&
         aligned16(a.dk) && aligned16(a.dv);
}

}  // namespace flash_bwd
