// The attention forward core, float32 on the tensor cores in 3xTF32,
// shared by two entry points:
//
//   * flash_attention.cu (row 2): the flash forward, causal or not, any
//     Sq and Sk, D <= 128 (kDrop false);
//   * small_attention.cu (row 5): the small-sequence training forward
//     with the attention-prob dropout drawn in the kernel (kDrop true).
//
// With s = (q . k) * scale + bias (s = -1e30 where causal and j > i):
//
//   m = max_j s,  l = sum_j exp(s - m),  lse = m + log(l)
//   out = sum_j pd_j v_j / l,  pd_j = exp(s_j - m)          (kDrop false)
//                              pd_j = keep ? exp(s_j - m) * inv_q : 0
//
// keep (kDrop, thr != 0) is u32 < thr of element ((b * H + h) * Sq + i)
// * Sk + j of the Philox stream (philox.cuh) keyed by (k0, k1): the
// small backward (small_attention_bwd.cu) re-draws the same bits.  The
// row sum l takes the undropped p, so out = (sum_j kept p_j inv_q v_j) /
// l, the reference's (p / l) * inv_q in another rounding order.  A
// fully masked row (every s == -1e30) softmaxes to a uniform average, so
// its output is mean(V), never NaN, as in the reference.
//
// Design:
//   * arithmetic: `mma.sync.m16n8k8` on TF32 operands (mma_tf32.cuh), in
//     3xTF32: each f32 operand is split into big = tf32(v) and small = v -
//     big, and small * big + big * small + big * big is summed, which
//     keeps the f32 contract where one TF32 product misses it (tests/
//     test_torch_flash_attention.py).  The tensor core cuts the sums it
//     accumulates, so each 32-deep slice of a product is summed there from
//     zero and added into f32 registers: s = q . k over D in slices of 32,
//     and p . v over a 32-key tile, one slice;
//   * one CTA of NW warps per (b, h, 16 NW query rows); each warp owns 16
//     rows and walks the key tiles of 32.  The scores stay in the mma's
//     accumulator fragments: a thread holds rows g and g + 8 of its warp
//     and keys 2 t4, 2 t4 + 1 of each 8-key group (g = lane / 4, t4 = lane
//     % 4).  The online softmax state (row max, row sum, output) is f32 in
//     registers; the row max is reduced over the quad by two shuffles,
//     the row sum kept per thread and reduced once at the end.  expf is
//     the accurate one, and the scale is applied after the dot, as the
//     reference does;
//   * p as the A operand of p . v, straight from the registers: the
//     product is summed over the 8 keys of a group in any order, so the
//     thread's two keys 2 t4 and 2 t4 + 1 are taken as k = t4 and t4 + 4
//     of the mma, and V's rows are read in that order (rows 2 t4, 2 t4 + 1
//     of the group): p never reaches shared memory;
//   * kDrop: the keep bits are drawn in registers, where the scores are.
//     A thread's two keys of a group lie in one Philox group of four
//     columns (nf * 8 + 4 (t4 >> 1) + 0..3; Sk and the tile's first key
//     are multiples of 4), which threads t4 and t4 ^ 1 share, for rows g
//     and g + 8.  The even thread of the pair draws row g's group and the
//     odd one row g + 8's, each keeps its four compares as a nibble, one
//     nibble per 8-key group, and the pair swaps the words with one
//     shuffle: 4 Philox calls a thread per 32-key tile, every u32 used
//     once.  The draw does not depend on the tile's copies, so it is
//     issued before the products and runs beside them.  (A cooperative
//     draw of the tile's bits into shared memory, one key tile ahead,
//     timed within 1% of it on an H100, faster at S = 128 and slower at
//     S = 256; PERF.md);
//   * loads: Q once into shared memory; K, V and the bias in a ring of
//     two stages of 32 keys, filled by cp.async (16-byte copies where D,
//     the row strides and the pointers allow, 4-byte ones otherwise),
//     zero-filled past D and past Sq / Sk, so a tile's loads run while the
//     previous tile is computed.  Rows of Q, K and V are padded to D + 4
//     floats and the bias tile's to 40, so every fragment load of a warp
//     falls in 32 distinct banks.  D is padded to a multiple of 8 with
//     those zeros;
//   * a CTA owns 64 rows (4 warps: 147 registers, 152 with kDrop, 73 KB
//     of shared memory, 3 CTAs an SM at D <= 64; 207 and 210 registers
//     at D = 128, one CTA); 32 and 128 rows (2, 8 warps) are built for
//     sweeps and checks (flash_attention.py `FWD_WARPS`);
//   * causal: key tiles wholly above the CTA's last row are skipped.
// q, k and v are read through (batch, head, row) strides with unit
// stride along D, so a transposed view needs no copy; bias, out and lse
// are contiguous.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace flash_fwd {

// keys of a tile (a multiple of 32) and ring stages: 64-key tiles or a
// third stage cost a 64-row CTA its third CTA an SM, and were slower at
// B = 32 on an H100 (0.131 and 0.085 ms against 0.070; PERF.md)
constexpr int kBK = 32;
constexpr int kStages = 2;
constexpr int kMaxD = 128;
constexpr int kLdB = kBK + 8;  // row stride of the bias tile
constexpr float kMask = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  float* out;
  float* lse;
  int H, Sq, Sk, D, bias_heads, causal;
  int vec_in;    // q, k, v: 16-byte copies
  int vec_bias;  // bias: 16-byte copies
  float scale;
  Strides qs, ks, vs;
  // kDrop: keep iff u32 < thr (0: no dropout) of the stream keyed by (k0,
  // k1), kept values times inv_q; block (0, 0, 0) stores k0, k1 to
  // seed_out when it is given
  uint32_t thr = 0u, k0 = 0u, k1 = 0u;
  float inv_q = 1.f;
  int* seed_out = nullptr;
};

template <int NW, int DW>
struct Tile {
  static constexpr int kT = 32 * NW;   // threads
  static constexpr int kBQ = 16 * NW;  // query rows
  static constexpr int kLd = DW + 4;   // row stride of the Q, K, V tiles
  static constexpr int kStage = 2 * kBK * kLd + kBQ * kLdB;
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBQ * kLd + (size_t)kStages * kStage);
};

// CTAs an SM for __launch_bounds__: as many as the shared memory allows
// (228 KB an SM, 1 KB of each CTA reserved) at D <= 64; one at D > 64,
// where the output and its slice partial take ~130 registers a thread
template <int NW, int DW>
constexpr int min_blocks() {
  return DW > 64 ? 1 : (int)(233472 / (Tile<NW, DW>::kSmem + 1024));
}

// rows [r0, r0 + R) x columns [0, W) of a strided source (columns at or
// past ncols and rows at or past nrows read as 0) into a tile of row
// stride ld, by T threads; vec: 16-byte copies (ncols and the row stride
// multiples of 4, the source 16-byte aligned)
template <int R, int W, int T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src,
                                          long long row_stride, int r0,
                                          int nrows, int ncols, bool vec,
                                          int tid) {
  if (vec) {
    constexpr int kChunks = W / 4;
#pragma unroll 4
    for (int c = tid; c < R * kChunks; c += T) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      const bool in = r0 + r < nrows && col < ncols;
      cp_async16(dst + r * ld + col,
                 in ? src + (r0 + r) * row_stride + col : src, in);
    }
  } else {
#pragma unroll 4
    for (int c = tid; c < R * W; c += T) {
      const int r = c / W, col = c % W;
      const bool in = r0 + r < nrows && col < ncols;
      cp_async4(dst + r * ld + col,
                in ? src + (r0 + r) * row_stride + col : src, in);
    }
  }
}

// The keep bits of the thread's 16 scores of key tile k0: bit 4 nf + e
// keeps s[nf][e] (e = 2 hr + j: row g + 8 hr, key nf * 8 + 2 t4 + j).
// ctr0: the Philox counter of the first four keys of the thread's drawn
// row (row g for even t4, g + 8 for odd) at key 0, plus t4 >> 1.
template <int NF>
__device__ __forceinline__ uint32_t keep_bits(unsigned long long ctr0,
                                              int k0, int t4,
                                              const Args& a) {
  const unsigned long long ctr = ctr0 + (unsigned)(k0 >> 2);
  uint32_t mine = 0u;  // nibble nf: the four compares of group nf
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    const uint4 w = philox::group(ctr + 2 * nf, a.k0, a.k1);
    mine |= ((uint32_t)(w.x < a.thr) | (uint32_t)(w.y < a.thr) << 1 |
             (uint32_t)(w.z < a.thr) << 2 | (uint32_t)(w.w < a.thr) << 3)
            << (4 * nf);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  // even t4: keys 2 t4, 2 t4 + 1 are lanes 0, 1 of the group; its own
  // draw is row g, the partner's row g + 8.  Odd t4: lanes 2, 3, its own
  // draw row g + 8
  const int odd = t4 & 1;
  const uint32_t rg = (odd ? other : mine) >> (2 * odd);
  const uint32_t rg8 = (odd ? mine : other) >> (2 * odd);
  // bits 4 nf + {0, 1} from row g, 4 nf + {2, 3} from row g + 8
  return (rg & 0x3333u) | ((rg8 & 0x3333u) << 2);
}

// NW warps, 16 query rows each; DW: the padded head width (64 or 128);
// kDrop: the attention-prob dropout (small_attention.cu)
template <int NW, int DW, bool kDrop>
__global__ void __launch_bounds__(32 * NW, (min_blocks<NW, DW>()))
flash_fwd_kernel(Args a) {
  using Cfg = Tile<NW, DW>;
  constexpr int T = Cfg::kT, BQ = Cfg::kBQ, LD = Cfg::kLd;
  constexpr int ND = DW / 8;   // 8-wide column groups of the output
  constexpr int NF = kBK / 8;  // 8-key groups of a key tile
  static_assert(NF == 4, "keep_bits packs four 8-key groups");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;  // BQ x LD
  float* ring = sQ + BQ * LD;

  const int D = a.D, Sq = a.Sq, Sk = a.Sk;
  const int Dp = (D + 7) & ~7;  // columns past D are zeros
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp * 16;  // the warp's first row in the tile
  const bool vec = a.vec_in != 0;

  bool drop = false;
  unsigned long long ctr0 = 0ull;
  if constexpr (kDrop) {
    if (a.seed_out != nullptr && blockIdx.x == 0 && h == 0 && b == 0 &&
        tid == 0) {
      a.seed_out[0] = (int)a.k0;
      a.seed_out[1] = (int)a.k1;
    }
    drop = a.thr != 0u;
    const unsigned long long row = q0 + wq + g + 8 * (t4 & 1);
    ctr0 = ((((unsigned long long)b * a.H + h) * Sq + row) * Sk >> 2) +
           (t4 >> 1);
  }

  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  const float* bb = nullptr;
  if (a.bias_heads > 0)
    bb = a.bias + ((size_t)b * a.bias_heads + (a.bias_heads > 1 ? h : 0)) *
                      (size_t)Sq * Sk;

  int nkt = (Sk + kBK - 1) / kBK;
  if (a.causal) {
    const int last_row = min(Sq, q0 + BQ) - 1;
    nkt = min(nkt, last_row / kBK + 1);
  }
  // K, V and the bias of key tile kt into ring stage st
  auto load_stage = [&](int st, int kt) {
    float* sK = ring + st * Cfg::kStage;
    float* sV = sK + kBK * LD;
    float* sB = sV + kBK * LD;
    const int k0 = kt * kBK;
    load_tile<kBK, DW, T>(sK, LD, kb, a.ks.s, k0, Sk, D, vec, tid);
    load_tile<kBK, DW, T>(sV, LD, vb, a.vs.s, k0, Sk, D, vec, tid);
    if (bb != nullptr)
      load_tile<BQ, kBK, T>(sB, kLdB, bb + k0, Sk, q0, Sq, Sk - k0,
                            a.vec_bias != 0, tid);
  };

  load_tile<BQ, DW, T>(sQ, LD, qb, a.qs.s, q0, Sq, D, vec, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) load_stage(st, st);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp: running max, this thread's share of the
  // running sum, and the output columns nd * 8 + 2 t4 (+1) of each group
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  const int row0 = q0 + wq + g;  // row of accumulator elements 0, 1

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    if (kt + kStages - 1 < nkt)
      load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const float* sK = ring + (kt % kStages) * Cfg::kStage;
    const float* sV = sK + kBK * LD;
    const float* sB = sV + kBK * LD;
    const int k0 = kt * kBK;

    uint32_t keep = 0u;
    if constexpr (kDrop) {
      if (drop) keep = keep_bits<NF>(ctr0, k0, t4, a);
    }

    // s = q . k over the warp's 16 rows x kBK keys, 32-deep slices of D
    float s[NF][4];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nf][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < DW; d0 += 32) {
      if (d0 >= Dp) break;
      float part[NF][4];
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nf][e] = 0.f;
#pragma unroll
      for (int kd = d0; kd < d0 + 32; kd += 8) {
        if (kd >= Dp) break;
        const float* qr = sQ + (wq + g) * LD + kd + t4;
        unsigned ab[4], as[4];
        split_tf32(qr[0], ab[0], as[0]);
        split_tf32(qr[8 * LD], ab[1], as[1]);
        split_tf32(qr[4], ab[2], as[2]);
        split_tf32(qr[8 * LD + 4], ab[3], as[3]);
        unsigned bbig[NF][2], bsml[NF][2];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          const float* kr = sK + (nf * 8 + g) * LD + kd + t4;
          split_tf32(kr[0], bbig[nf][0], bsml[nf][0]);
          split_tf32(kr[4], bbig[nf][1], bsml[nf][1]);
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_tf32(part[nf], as, bbig[nf]);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_tf32(part[nf], ab, bsml[nf]);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_tf32(part[nf], ab, bbig[nf]);
      }
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nf][e] += part[nf][e];
    }

    // scale, bias, masks; the tile's row max over the quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;  // 0: row g, 1: row g + 8
        const int kc = nf * 8 + 2 * t4 + (e & 1);
        const int col = k0 + kc;
        float x = s[nf][e] * a.scale;  // scale after the dot, as reference
        if (col >= Sk) {
          x = -INFINITY;  // tail column: weight exactly 0
        } else {
          if (bb != nullptr) x += sB[(wq + g + 8 * hr) * kLdB + kc];
          if (a.causal && col > row0 + 8 * hr) x = kMask;
        }
        s[nf][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = expf(m[hr] - mx[hr]);
      m[hr] = mx[hr];
      l[hr] *= alpha[hr];
    }
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nf][e] - mx[e >> 1]);
        s[nf][e] = p;
        l[e >> 1] += p;  // the row sum takes the undropped p
        if constexpr (kDrop) {
          if (drop) s[nf][e] = (keep >> (4 * nf + e)) & 1u ? p * a.inv_q
                                                            : 0.f;
        }
      }

    // o = o * alpha + p . v, each 32 keys one slice, summed from zero
#pragma unroll
    for (int kf0 = 0; kf0 < NF; kf0 += 4) {
      float pv[ND][4];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[nd][e] = 0.f;
#pragma unroll
      for (int kf = kf0; kf < kf0 + 4; ++kf) {
        // k = t4 is key 2 t4 of the group, k = t4 + 4 key 2 t4 + 1
        unsigned ab[4], as[4];
        split_tf32(s[kf][0], ab[0], as[0]);
        split_tf32(s[kf][2], ab[1], as[1]);
        split_tf32(s[kf][1], ab[2], as[2]);
        split_tf32(s[kf][3], ab[3], as[3]);
        const float* vr = sV + (kf * 8 + 2 * t4) * LD + g;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          if (nd * 8 >= Dp) break;
          unsigned bbig[2], bsml[2];
          split_tf32(vr[nd * 8], bbig[0], bsml[0]);
          split_tf32(vr[LD + nd * 8], bbig[1], bsml[1]);
          mma_tf32(pv[nd], as, bbig);
          mma_tf32(pv[nd], ab, bsml);
          mma_tf32(pv[nd], ab, bbig);
        }
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nd][e] = (kf0 == 0 ? o[nd][e] * alpha[e >> 1] : o[nd][e]) +
                     pv[nd][e];
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

  const size_t head = (size_t)b * a.H + h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float L = l[hr];
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    L = L == 0.f ? 1.f : L;
    const int row = row0 + 8 * hr;
    if (row >= Sq) continue;
    float* orow = a.out + (head * Sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = nd * 8 + 2 * t4;
      const float x0 = o[nd][2 * hr] / L, x1 = o[nd][2 * hr + 1] / L;
      if ((D & 1) == 0) {
        if (d < D) *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
      } else {
        if (d < D) orow[d] = x0;
        if (d + 1 < D) orow[d + 1] = x1;
      }
    }
    if (t4 == 0) a.lse[head * Sq + row] = m[hr] + logf(L);
  }
}

// The dynamic shared-memory limit and the carveout (all of the SM's 228 KB
// to shared memory) are set once per device and instantiation, so that a
// launch costs no attribute call.
template <int NW, int DW, bool kDrop>
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<NW, DW, kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<NW, DW>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_kernel<NW, DW, kDrop>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int NW, int DW, bool kDrop>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = prepare<NW, DW, kDrop>();
  if (err != cudaSuccess) return err;
  constexpr int rows = Tile<NW, DW>::kBQ, threads = Tile<NW, DW>::kT;
  constexpr size_t smem = Tile<NW, DW>::kSmem;
  const dim3 grid((a.Sq + rows - 1) / rows, a.H, B);
  flash_fwd_kernel<NW, DW, kDrop><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NW, int DW, bool kDrop>
cudaError_t ctas(int* n) {
  cudaError_t err = prepare<NW, DW, kDrop>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, flash_fwd_kernel<NW, DW, kDrop>, Tile<NW, DW>::kT,
      Tile<NW, DW>::kSmem);
}

// the instantiation for D (padded to 64 or 128)
template <int NW, bool kDrop>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  return a.D > 64 ? launch<NW, 128, kDrop>(a, B, stream)
                  : launch<NW, 64, kDrop>(a, B, stream);
}

template <int NW, bool kDrop>
cudaError_t ctas_d(int D, int* n) {
  return D > 64 ? ctas<NW, 128, kDrop>(n) : ctas<NW, 64, kDrop>(n);
}

inline bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// Args of a forward call without dropout (the kDrop fields at their
// defaults); the entry points check the geometry
inline Args make_args(const float* q, const float* k, const float* v,
                      const float* bias, float* out, float* lse, int H,
                      int Sq, int Sk, int D, int bias_heads, int causal,
                      float scale, long long q_sb, long long q_sh,
                      long long q_ss, long long k_sb, long long k_sh,
                      long long k_ss, long long v_sb, long long v_sh,
                      long long v_ss) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.out = out;
  a.lse = lse;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.bias_heads = bias_heads;
  a.causal = causal;
  a.scale = scale;
  a.qs = Strides{q_sb, q_sh, q_ss};
  a.ks = Strides{k_sb, k_sh, k_ss};
  a.vs = Strides{v_sb, v_sh, v_ss};
  a.vec_in = D % 4 == 0 && q_sb % 4 == 0 && q_sh % 4 == 0 &&
             q_ss % 4 == 0 && k_sb % 4 == 0 && k_sh % 4 == 0 &&
             k_ss % 4 == 0 && v_sb % 4 == 0 && v_sh % 4 == 0 &&
             v_ss % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  a.vec_bias = bias != nullptr && Sk % 4 == 0 && aligned16(bias);
  return a;
}

}  // namespace flash_fwd
