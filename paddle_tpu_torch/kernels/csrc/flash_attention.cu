// Flash attention forward for Hopper (sm_90a), float32, on the tensor
// cores in 3xTF32.
//
// Replaces: paddle_tpu/pallas_kernels/flash_attention.py `_fwd_kernel`
// (launched by `_fwd_pallas`).  Same function:
//
//   s[b,h,i,j] = (q[b,h,i] . k[b,h,j]) * scale + bias[b, h|0, i, j]
//   s = -1e30 where causal and j > i      (finite, as in the reference)
//   out = softmax_j(s) @ v,  lse = logsumexp_j(s)        (lse in f32)
//
// A fully masked row (every s == -1e30) softmaxes to a uniform average,
// so its output is mean(V), never NaN, as in the reference.  Unlike the
// TPU kernel, which needs Sq and Sk to be multiples of its 128..1024
// blocks, any Sq and Sk are taken: tail rows are computed and not
// written, tail columns score -inf (weight exactly 0).  D <= 128.
//
// Bound: 4*B*H*Sq*Sk*D flops against (q+k+v+bias+out+lse) bytes.  On the
// f32 SIMT pipes (67 TF/s) BERT's S = 128, D = 64 is operations-bound
// (~32 flops a byte against a ~20 flop/byte ridge); in 3xTF32 on the
// tensor cores (three TF32 products per f32 product at 495 TF/s) it is
// bytes-bound: at B = 8, 13.1 MB take 0.0039 ms at 3.35 TB/s, the 1.21
// GFLOP of TF32 products 0.0024 ms.
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
//   * loads: Q once into shared memory; K, V and the bias in a ring of
//     two stages of 32 keys, filled by cp.async (16-byte copies where D,
//     the row strides and the pointers allow, 4-byte ones otherwise),
//     zero-filled past D and past Sq / Sk, so a tile's loads run while the
//     previous tile is computed.  Rows of Q, K and V are padded to D + 4
//     floats and the bias tile's to 40, so every fragment load of a warp
//     falls in 32 distinct banks.  D is padded to a multiple of 8 with
//     those zeros;
//   * a CTA owns 64 rows (4 warps: 147 registers, 73 KB of shared memory,
//     3 CTAs an SM at D <= 64); 32 and 128 rows (2, 8 warps) are built
//     for sweeps and checks (flash_attention.py `FWD_WARPS`);
//   * causal: key tiles wholly above the CTA's last row are skipped.
// q, k and v are read through (batch, head, row) strides with unit
// stride along D, so a transposed view needs no copy; bias, out and lse
// are contiguous.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "mma_tf32.cuh"

namespace {

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

// NW warps, 16 query rows each; DW: the padded head width (64 or 128)
template <int NW, int DW>
__global__ void __launch_bounds__(32 * NW, (min_blocks<NW, DW>()))
flash_fwd_kernel(Args a) {
  using Cfg = Tile<NW, DW>;
  constexpr int T = Cfg::kT, BQ = Cfg::kBQ, LD = Cfg::kLd;
  constexpr int ND = DW / 8;   // 8-wide column groups of the output
  constexpr int NF = kBK / 8;  // 8-key groups of a key tile
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
        l[e >> 1] += p;
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
template <int NW, int DW>
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<NW, DW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<NW, DW>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_kernel<NW, DW>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int NW, int DW>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = prepare<NW, DW>();
  if (err != cudaSuccess) return err;
  constexpr int rows = Tile<NW, DW>::kBQ, threads = Tile<NW, DW>::kT;
  constexpr size_t smem = Tile<NW, DW>::kSmem;
  const dim3 grid((a.Sq + rows - 1) / rows, a.H, B);
  flash_fwd_kernel<NW, DW><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NW, int DW>
cudaError_t ctas(int* n) {
  cudaError_t err = prepare<NW, DW>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, flash_fwd_kernel<NW, DW>, Tile<NW, DW>::kT, Tile<NW, DW>::kSmem);
}

// the instantiation for D (padded to 64 or 128)
template <int NW>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  return a.D > 64 ? launch<NW, 128>(a, B, stream)
                  : launch<NW, 64>(a, B, stream);
}

template <int NW>
cudaError_t ctas_d(int D, int* n) {
  return D > 64 ? ctas<NW, 128>(n) : ctas<NW, 64>(n);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

// warps: the CTA's warps, 2, 4 or 8 (flash_attention.py `FWD_WARPS`)
extern "C" cudaError_t flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, float* lse, int B, int H, int Sq, int Sk, int D,
    int bias_heads, int causal, float scale, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int warps,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > kMaxD ||
      B > 65535 || H > 65535 ||
      (bias_heads != 0 && bias_heads != 1 && bias_heads != H) ||
      (bias_heads != 0 && bias == nullptr) || !aligned16(out))
    return cudaErrorInvalidValue;
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
  switch (warps) {
    case 2: return launch_d<2>(a, B, stream);
    case 4: return launch_d<4>(a, B, stream);
    case 8: return launch_d<8>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// CTAs of the kernel for (D, warps) resident on one SM at once (reports)
extern "C" cudaError_t flash_attention_fwd_ctas_per_sm(int D, int warps,
                                                       int* n) {
  switch (warps) {
    case 2: return ctas_d<2>(D, n);
    case 4: return ctas_d<4>(D, n);
    case 8: return ctas_d<8>(D, n);
    default: return cudaErrorInvalidValue;
  }
}
