// The conv + batch-norm + relu block for Hopper (sm_90a), NCHW float32:
// an implicit-GEMM conv core on the tensor cores, and an affine pass.
//
// Replaces: paddle_tpu/pallas_kernels/conv_block.py
//   * row 11, `_infer_kernel` (launched by `_infer_pallas`):
//       y = act(conv(x, w) * a + b), a and b folded on the host from the
//       running statistics (`conv_bn_act_f32`);
//   * row 12, `_train_conv_kernel` (launched by `_train_pallas`): the conv
//       and its per-image, per-channel sum and sum of squares, [N, C_out]
//       each (`conv_stats_f32`);
//   * row 13, `_affine_relu_kernel` (launched by `_affine_pallas`):
//       y = act(conv * a + b) over [N, C_out, OH, OW] (`affine_act_f32`).
//
// The conv is one GEMM over the whole batch:
//   out[co, p] = sum_k W[co, k] * X[k, p],  M = C_out, N = N * OH * OW
// (every output pixel of the batch), K = C * kh * kw, k over (c, r, s),
// X[k, p] = x[img(p), c, oh(p) * stride - pad + r, ow(p) * stride - pad
// + s] (zero outside the image), gathered on the fly (implicit GEMM).
//
// What bounds it on this card: operations.  A ResNet-50 3x3 conv at 14 x
// 14 does ~2300 flops per byte it must move; the TPU kernel's kh * kw
// shifted MXU products need a matrix unit here too, and the f32 SIMT
// pipes (67 TF/s) are a quarter of what the tensor cores give f32 work
// through 3xTF32 (495 TF/s TF32, three products per f32 product).  The
// design:
//   * arithmetic: `mma.sync.m16n8k8` on TF32 operands (`split_tf32`,
//     `mma_tf32` and the cp.async helpers: mma_tf32.cuh, shared with the
//     flash-attention kernels).  Each f32 operand is split at fragment
//     load into big = v rounded to TF32 and small =
//     v - big; small * big and big * small are summed first, then big *
//     big.  The dropped small * small term is ~2^-22 of a product, so the
//     result keeps the port's f32 contract (1xTF32 misses it ~10x at
//     ResNet's K; tests/test_torch_conv_tf32.py).  The tensor core cuts
//     (rounds toward zero) the sums it accumulates, which over K = 2304
//     drifts ~1.6e-4 from an f32 conv, past CONV_ATOL: each K slice of 32
//     is summed there from zero and added into f32 registers.  `mma.sync`
//     takes fragments from registers, which is where the split happens;
//     `wgmma` would want both halves written back to shared memory as
//     swizzled K-major tiles (later work).
//   * tiles flattened over the batch: a CTA owns BM output channels x BN
//     pixels of the flattened N, and a tile may span images, so stage 3
//     (OH OW = 196) and stage 4 (49) waste no lanes at an image's edge.
//     Two tile shapes (`kTiles`), 64 x 128 and 64 x 64; the wrapper picks
//     one per launch by the rule in conv_block.py (`conv_tile`), so that
//     the grid fills the 132 SMs.
//   * loads: a ring of kStages K slices of 32 in dynamic shared memory,
//     filled by cp.async with one barrier per slice; a slice's copies are
//     issued in four parts between the four k8 steps of the slice two
//     ahead, and each k8 step's fragments are read from shared memory
//     during the step before.  Weights are contiguous along K: 16-byte
//     copies where K % 4 == 0 (4-byte for the stem's 147).  The input is
//     read by one of three loaders (kLoad), chosen from the shape:
//       - a 1x1 stride-1 conv reads B as a plain slice of x: 16-byte
//         copies where OH * OW % 4 == 0 (kVec1x1);
//       - where C % 32 == 0, k runs (r, s, c), so a slice is 32 channels
//         of one tap: one bounds check per pixel and slice and one pointer
//         step per row; the entry first writes the weights in that order
//         (kTapMajor);
//       - otherwise (the stem's C = 3, odd shapes) the general gather,
//         k = (c, r, s): a table of kk + 32 taps built once per CTA; a
//         slice starting at k0 = cb * kk + rb reads taps rb..rb + 31, each
//         an offset from channel cb and its (r, s); cb and rb advance by
//         constants, so the loop divides nothing (kGather).
//     The input copies are 4 bytes but for kVec1x1, src-size 0 zero-filling
//     the padding and the ragged edge.  Each thread computes its pixel's
//     image base, ih0 and iw0, and a mask of the taps inside the image,
//     once.  Shared rows are padded (A: 36 floats, B: BN + 8) so the
//     fragment loads hit 32 distinct banks.
//   * epilogue: the accumulators go through shared memory (the ring is
//     free by then), so a warp writes 32 contiguous pixels of one channel
//     plane; row 11 applies acc * a + b and relu there.
//
// Row 12's statistics.  After the conv tile is staged, each (channel,
// image in the tile) pair sums its columns in a fixed order into partials
// [pixel tile, image slot, channel] (slot = image - the tile's first
// image); a second small kernel sums each (image, channel)'s partials in
// tile order.  No float atomics: card runs repeat bit for bit.  The host
// folds the batch statistics as the reference does (v = E[x^2] - m^2).
//
// Row 13 is a pass over memory: bound by bytes (read the conv, write y).
// Its multiply and add are explicitly rounded intrinsics, never contracted
// into an FMA, so it is bitwise the plain version's conv * a + b.
//
// Entry points: plain C, each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;  // the weight-order, reduce and affine kernels
constexpr int kBK = 32;        // K slice of one ring stage
constexpr int kStages = 3;     // ring depth
constexpr int kPadA = 4;       // A row stride kBK + 4
constexpr int kPadB = 8;       // B row stride BN + 8
constexpr int kMaxTaps = 49;   // kh * kw <= 7 * 7
constexpr int kTab = kMaxTaps + kBK - 1;

struct Shape {
  int n, c, h, w, co, k, stride, pad, oh, ow;
};

// how the conv kernel reads its input (conv_mma_kernel's kLoad)
constexpr int kGather = 0, kVec1x1 = 1, kTapMajor = 2;

// tile shapes (BM x BN), indexed by the wrapper's `tile` argument
// (conv_block.py's TILES): 64 x 128 with four warps of 64 x 32, and 64 x 64
// with four warps of 32 x 32
struct TileCfg {
  int bm, bn;
};
constexpr TileCfg kTiles[] = {{64, 128}, {64, 64}};
constexpr int kNumTiles = 2;

// one tap of the slice table: k = cb * kk + j reads channel cb + j / kk
// at (r, s) = ((j % kk) / k, (j % kk) % k)
struct __align__(16) Tap {
  long long off;  // (j / kk) * H * W + r * W + s
  int rs;         // r * k + s: the bit of the thread's tap mask
  int unused;
};

template <int BM, int BN>
constexpr int ring_floats() {
  return kStages * (BM * (kBK + kPadA) + kBK * (BN + kPadB));
}

// kStats false: row 11, out = act(acc * a + b).
// kStats true: row 12, out = acc, and the tile's (image, channel) partials.
// kLoad, how B (the input) is read:
//   kGather: any shape; k = (c, r, s), each row's tap from the table;
//   kVec1x1: a 1x1 stride-1 conv without padding, OH * OW % 4 == 0 and x
//     16-byte aligned: B rows are slices of x read 16 bytes at a time;
//   kTapMajor: C % 32 == 0: k = (r, s, c), so a slice is 32 channels of
//     one tap: one bounds check per pixel and slice, one pointer step per
//     row; wt holds the weights in that order ([co][r][s][c]).
// vec_a: K % 4 == 0 and wt 16-byte aligned: A is read 16 bytes at a time.
template <int BM, int BN, int WM, int WN, bool kStats, int kLoad>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
conv_mma_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, float* __restrict__ part_s,
                float* __restrict__ part_ss, Shape s, int relu, int vec_a,
                int slots) {
  constexpr int kWarpsN = BN / WN;
  constexpr int T = (BM / WM) * kWarpsN * 32;
  constexpr int MF = WM / 16, NF = WN / 8;
  constexpr int SA = kBK + kPadA, SB = BN + kPadB, SC = BN + 1;
  constexpr int kStage = BM * SA + kBK * SB;
  static_assert(T % BN == 0 && (kBK * BN) % T == 0, "B gather roles");
  static_assert(T % (BN / 4) == 0 && (kBK * BN / 4) % T == 0, "B 16-byte");
  static_assert(T % (kBK / 4) == 0 && (BM * kBK / 4) % T == 0, "A 16-byte");
  static_assert(T % kBK == 0 && (BM * kBK) % T == 0, "A 4-byte roles");
  static_assert(BM * SC <= kStages * kStage, "epilogue tile fits the ring");
  extern __shared__ __align__(16) float smem[];
  __shared__ Tap tab[kTab];

  const int tid = threadIdx.x;
  const int P = s.oh * s.ow;
  const int npix = s.n * P;
  const int kk = s.k * s.k;
  const int K = s.c * kk;
  const long long hw = (long long)s.h * s.w;
  const int p0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int nk = (K + kBK - 1) / kBK;

  // the slice table (once per CTA; the only divisions of the gather)
  if (kLoad == kGather) {
    for (int j = tid; j < kk + kBK - 1; j += T) {
      const int dc = j / kk, rs = j - dc * kk;
      const int r = rs / s.k;
      tab[j].off = dc * hw + (long long)r * s.w + (rs - r * s.k);
      tab[j].rs = rs;
    }
  }

  // B gather roles: one pixel column, rows b_row + i * (T / BN)
  const int b_col = tid % BN, b_row = tid / BN;
  long long b_base = 0;          // the pixel's x offset at c = r = s = 0
  unsigned long long taps = 0;   // bit r * k + s: (ih0 + r, iw0 + s) inside
  // B 16-byte roles (1x1): one 4-pixel group, rows v_row + i * v_step
  constexpr int kGroups = BN / 4;
  const int v_grp = tid % kGroups, v_row = tid / kGroups;
  bool v_ok = false;
  if (kLoad == kVec1x1) {
    const int gp = p0 + v_grp * 4;
    if (gp < npix) {
      const int img = gp / P;
      b_base = (long long)img * s.c * P + (gp - img * P);
      v_ok = true;
    }
  } else {
    const int gp = p0 + b_col;
    if (gp < npix) {
      const int img = gp / P, pix = gp - img * P;
      const int oh = pix / s.ow, ow = pix - oh * s.ow;
      const int ih0 = oh * s.stride - s.pad, iw0 = ow * s.stride - s.pad;
      b_base = (long long)img * s.c * hw + (long long)ih0 * s.w + iw0;
      unsigned long long cols = 0;
      for (int c = 0; c < s.k; ++c)
        if (iw0 + c >= 0 && iw0 + c < s.w) cols |= 1ull << c;
      for (int r = 0; r < s.k; ++r)
        if (ih0 + r >= 0 && ih0 + r < s.h) taps |= cols << (r * s.k);
    }
  }
  __syncthreads();  // the table

  // the next slice to load: k0 = cb * kk + rb, cbhw = cb * H * W (the
  // gather); k0 = (r * k + s) * C + c0 (tap-major)
  const int q = kBK / kk, rmod = kBK - q * kk;
  int ld_k0 = 0, ld_rb = 0, ld_c0 = 0, ld_r = 0, ld_s = 0;
  long long ld_cbhw = 0;

  // a quarter of the slice's copies (part 0..3), so the loads of slice
  // kt + 2 interleave with slice kt's four k8 steps
  constexpr int kParts = kBK / 8;
  auto load_part = [&](int stage, int part) {
    float* As = smem + stage * kStage;
    float* Bs = As + BM * SA;
    if (vec_a) {
      constexpr int n = BM * kBK / 4 / T;
#pragma unroll
      for (int i = part * n / kParts; i < (part + 1) * n / kParts; ++i) {
        const int row = tid / (kBK / 4) + i * (T / (kBK / 4));
        const int kq = (tid % (kBK / 4)) * 4;
        const int co = co0 + row, kx = ld_k0 + kq;
        const bool ok = co < s.co && kx < K;
        cp_async16(As + row * SA + kq, ok ? wt + (long long)co * K + kx : wt,
                   ok);
      }
    } else {
      constexpr int n = BM * kBK / T;
#pragma unroll
      for (int i = part * n / kParts; i < (part + 1) * n / kParts; ++i) {
        const int row = tid / kBK + i * (T / kBK);
        const int kc = tid % kBK;
        const int co = co0 + row, kx = ld_k0 + kc;
        const bool ok = co < s.co && kx < K;
        cp_async4(As + row * SA + kc, ok ? wt + (long long)co * K + kx : wt,
                  ok);
      }
    }
    if (kLoad == kVec1x1) {
      constexpr int n = kBK * kGroups / T;
#pragma unroll
      for (int i = part * n / kParts; i < (part + 1) * n / kParts; ++i) {
        const int kr = v_row + i * (T / kGroups);
        const bool ok = v_ok && ld_k0 + kr < K;
        cp_async16(Bs + kr * SB + v_grp * 4,
                   ok ? x + b_base + (long long)(ld_k0 + kr) * P : x, ok);
      }
    } else if (kLoad == kTapMajor) {
      constexpr int n = kBK * BN / T;
      // out of the image: src-size 0 from rows of x that exist (C >= 32)
      const bool ok = (taps >> (ld_r * s.k + ld_s)) & 1ull;
      const float* xs =
          ok ? x + (b_base + ld_c0 * hw + (long long)ld_r * s.w + ld_s) : x;
#pragma unroll
      for (int i = part * n / kParts; i < (part + 1) * n / kParts; ++i) {
        const int kr = b_row + i * (T / BN);
        cp_async4(Bs + kr * SB + b_col, xs + kr * hw, ok);
      }
    } else {
      constexpr int n = kBK * BN / T;
      const float* xs = x + (b_base + ld_cbhw);
#pragma unroll
      for (int i = part * n / kParts; i < (part + 1) * n / kParts; ++i) {
        const int kr = b_row + i * (T / BN);
        const Tap t = tab[ld_rb + kr];
        const bool ok = ld_k0 + kr < K && ((taps >> t.rs) & 1ull);
        cp_async4(Bs + kr * SB + b_col, ok ? xs + t.off : x, ok);
      }
    }
  };
  auto next_slice = [&]() {
    ld_k0 += kBK;
    if (kLoad == kTapMajor) {
      ld_c0 += kBK;
      if (ld_c0 == s.c) {
        ld_c0 = 0;
        if (++ld_s == s.k) {
          ld_s = 0;
          ++ld_r;
        }
      }
    }
    ld_rb += rmod;
    ld_cbhw += q * hw;
    if (ld_rb >= kk) {
      ld_rb -= kk;
      ld_cbhw += hw;
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) {
#pragma unroll
      for (int part = 0; part < kParts; ++part) load_part(st, part);
      next_slice();
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1's stage is free
    const bool more = kt + kStages - 1 < nk;
    const int fill = (kt + kStages - 1) % kStages;
    const float* As = smem + (kt % kStages) * kStage;
    const float* Bs = As + BM * SA;
    // the slice's products go to `sacc`, then into `acc` by rounded adds:
    // the tensor core truncates the sums it accumulates, so a running sum
    // of all K there would drift toward zero by ~half an ulp a product
    float sacc[MF][NF][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.f;
    // raw fragments, double-buffered: k8 step ks + 1's shared loads are
    // issued before step ks's splits and products
    float fa[2][MF][4], fb[2][NF][2];
    auto lds = [&](int buf, int ks) {
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const float* ar = As + (wm + i * 16 + g) * SA + ks + t4;
        fa[buf][i][0] = ar[0];
        fa[buf][i][1] = ar[8 * SA];
        fa[buf][i][2] = ar[4];
        fa[buf][i][3] = ar[8 * SA + 4];
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float* br = Bs + (ks + t4) * SB + wn + j * 8 + g;
        fb[buf][j][0] = br[0];
        fb[buf][j][1] = br[4 * SB];
      }
    };
    lds(0, 0);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      const int cur = (ks / 8) & 1;
      if (ks + 8 < kBK) lds(cur ^ 1, ks + 8);
      if (more) load_part(fill, ks / 8);
      unsigned ab[MF][4], as[MF][4], bb[NF][2], bs[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(fa[cur][i][e], ab[i][e], as[i][e]);
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split_tf32(fb[cur][j][e], bb[j][e], bs[j][e]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(sacc[i][j], as[i], bb[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(sacc[i][j], ab[i], bs[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32(sacc[i][j], ab[i], bb[j]);
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += sacc[i][j][e];
    if (more) next_slice();
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // stage the tile [BM][BN] (row stride BN + 1) through the ring
  float* Cs = smem;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      float* c = Cs + (wm + i * 16 + g) * SC + wn + j * 8 + 2 * t4;
      c[0] = acc[i][j][0];
      c[1] = acc[i][j][1];
      c[8 * SC] = acc[i][j][2];
      c[8 * SC + 1] = acc[i][j][3];
    }
  __syncthreads();

  // a thread per pixel column, rows o_row + i * (T / BN): a warp writes
  // 32 contiguous pixels of one channel plane
  {
    const int gp = p0 + b_col;
    if (gp < npix) {
      const int img = gp / P;
      float* o = out + (long long)img * s.co * P + (gp - img * P);
      for (int r = b_row; r < BM && co0 + r < s.co; r += T / BN) {
        const int co = co0 + r;
        float v = Cs[r * SC + b_col];
        if (!kStats) {
          v = v * a[co] + b[co];
          if (relu) v = fmaxf(v, 0.f);
        }
        o[(long long)co * P] = v;
      }
    }
  }
  if (kStats) {
    // a thread per (channel, image in the tile): column c0 + j into lane
    // j % 4 of four running sums (four independent add chains), then
    // (lane 0 + lane 1) + (lane 2 + lane 3): a fixed order
    const int img0 = p0 / P;
    const int end = min(p0 + BN, npix);
    const int nseg = (end - 1) / P - img0 + 1;
    for (int idx = tid; idx < BM * nseg; idx += T) {
      const int r = idx % BM, sl = idx / BM;
      const int co = co0 + r;
      if (co >= s.co) continue;
      const int img = img0 + sl;
      const int c0 = max(p0, img * P) - p0;
      const int c1 = min(end, (img + 1) * P) - p0;
      const float* row = Cs + r * SC;
      float sum[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};
      int c = c0;
      for (; c + 4 <= c1; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = row[c + u];
          sum[u] += v;
          sq[u] += v * v;
        }
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (c + u < c1) {
          const float v = row[c + u];
          sum[u] += v;
          sq[u] += v * v;
        }
      }
      const long long at = ((long long)blockIdx.x * slots + sl) * s.co + co;
      part_s[at] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
      part_ss[at] = (sq[0] + sq[1]) + (sq[2] + sq[3]);
    }
  }
}

// w [co][c][kk] -> wp [co][kk][c]: the tap-major loader's weight order
__global__ void __launch_bounds__(kThreads)
tap_major_kernel(const float* __restrict__ w, float* __restrict__ wp,
                 long long total, int c, int kk) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / c;  // co * kk + tap
  const int ch = (int)(i - row * c);
  const long long o = row / kk;
  wp[i] = w[(o * c + ch) * kk + (row - o * kk)];
}

// Sum each (image, channel)'s partials over the pixel tiles that cover
// the image, in tile order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ part_s,
                    const float* __restrict__ part_ss, float* __restrict__ s,
                    float* __restrict__ ss, int n, int co, int P, int bn,
                    int slots) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * co) return;
  const int img = i / co;
  const int c = i - img * co;
  const long long first = (long long)img * P, last = first + P - 1;
  float a = 0.f, b = 0.f;
  for (long long t = first / bn; t <= last / bn; ++t) {
    const long long sl = img - t * bn / P;
    const long long at = (t * slots + sl) * co + c;
    a += part_s[at];
    b += part_ss[at];
  }
  s[i] = a;
  ss[i] = b;
}

// y = act(conv * a[c] + b[c]), rounded after the product as the plain
// version is; kVec: 4 elements of one channel plane per
// float4 (the plane size is a multiple of 4)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
affine_act_kernel(const float* __restrict__ conv, const float* __restrict__ a,
                  const float* __restrict__ b, float* __restrict__ y,
                  long long total, int co, int plane, int relu) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i0 >= total) return;
  if (kVec) {
    const int c = (int)((i0 / plane) % co);
    const float sa = a[c], sb = b[c];
    float4 v = *reinterpret_cast<const float4*>(conv + i0);
    v.x = __fadd_rn(__fmul_rn(v.x, sa), sb);
    v.y = __fadd_rn(__fmul_rn(v.y, sa), sb);
    v.z = __fadd_rn(__fmul_rn(v.z, sa), sb);
    v.w = __fadd_rn(__fmul_rn(v.w, sa), sb);
    if (relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    *reinterpret_cast<float4*>(y + i0) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      if (i >= total) break;
      const int c = (int)((i / plane) % co);
      float v = __fadd_rn(__fmul_rn(conv[i], a[c]), b[c]);
      if (relu) v = fmaxf(v, 0.f);
      y[i] = v;
    }
  }
}

bool shape_ok(int n, const Shape& s) {
  if (!(n > 0 && s.c > 0 && s.h > 0 && s.w > 0 && s.co > 0 && s.k > 0 &&
        s.k * s.k <= kMaxTaps && s.stride > 0 && s.pad >= 0 && s.oh > 0 &&
        s.ow > 0 && s.oh == (s.h + 2 * s.pad - s.k) / s.stride + 1 &&
        s.ow == (s.w + 2 * s.pad - s.k) / s.stride + 1))
    return false;
  // int pixel and K indices, with a tile's width of headroom
  const long long npix = (long long)n * s.oh * s.ow;
  const long long K = (long long)s.c * s.k * s.k;
  return npix + 2LL * s.oh * s.ow + 256 < 0x7fffffffLL &&
         K + 64 < 0x7fffffffLL && (s.co + 63) / 64 <= 65535;
}

int pixel_tiles(int n, const Shape& s, int bn) {
  return (int)(((long long)n * s.oh * s.ow + bn - 1) / bn);
}

// image slots of a pixel tile: the images BN consecutive pixels can touch
int tile_slots(int n, const Shape& s, int bn) {
  const int p = s.oh * s.ow;
  const int span = (bn - 1 + p - 1) / p + 1;
  return span < n ? span : n;
}

template <int BM, int BN, int WM, int WN, bool kStats, int kLoad>
cudaError_t launch_tile(const float* x, const float* w, const float* a,
                        const float* b, float* out, float* part_s,
                        float* part_ss, const Shape& s, int relu, int vec_a,
                        int slots, cudaStream_t stream) {
  auto kern = conv_mma_kernel<BM, BN, WM, WN, kStats, kLoad>;
  const int smem = ring_floats<BM, BN>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)pixel_tiles(s.n, s, BN),
                  (unsigned)((s.co + BM - 1) / BM));
  kern<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(
      x, w, a, b, out, part_s, part_ss, s, relu, vec_a, slots);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN, bool kStats, int kLoad>
cudaError_t tile_occupancy(int* ctas) {
  auto kern = conv_mma_kernel<BM, BN, WM, WN, kStats, kLoad>;
  const int smem = ring_floats<BM, BN>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kern, (BM / WM) * (BN / WN) * 32, smem);
}

template <bool kStats, int kLoad>
cudaError_t launch_conv(int tile, const float* x, const float* w,
                        const float* a, const float* b, float* out,
                        float* part_s, float* part_ss, const Shape& s,
                        int relu, int vec_a, int slots,
                        cudaStream_t stream) {
  return tile == 0
             ? launch_tile<64, 128, 64, 32, kStats, kLoad>(
                   x, w, a, b, out, part_s, part_ss, s, relu, vec_a, slots,
                   stream)
             : launch_tile<64, 64, 32, 32, kStats, kLoad>(
                   x, w, a, b, out, part_s, part_ss, s, relu, vec_a, slots,
                   stream);
}

template <bool kStats>
cudaError_t conv_launch(int tile, const float* x, const float* w,
                        float* wtap, const float* a, const float* b,
                        float* out, float* part_s, float* part_ss,
                        const Shape& s, int relu, int slots,
                        cudaStream_t stream) {
  const int kk = s.k * s.k;
  const long long K = (long long)s.c * kk;
  if (s.k == 1 && s.stride == 1 && s.pad == 0 && (s.oh * s.ow) % 4 == 0 &&
      (size_t)x % 16 == 0)
    return launch_conv<kStats, kVec1x1>(
        tile, x, w, a, b, out, part_s, part_ss, s, relu,
        K % 4 == 0 && (size_t)w % 16 == 0, slots, stream);
  if (s.c % kBK != 0)
    return launch_conv<kStats, kGather>(
        tile, x, w, a, b, out, part_s, part_ss, s, relu,
        K % 4 == 0 && (size_t)w % 16 == 0, slots, stream);
  const float* wt = w;
  if (kk > 1) {  // [co][c][r][s] -> [co][r][s][c] into the caller's scratch
    if (wtap == nullptr) return cudaErrorInvalidValue;
    const long long total = K * s.co;
    tap_major_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(w, wtap, total, s.c, kk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wt = wtap;
  }
  return launch_conv<kStats, kTapMajor>(
      tile, x, wt, a, b, out, part_s, part_ss, s, relu,
      (size_t)wt % 16 == 0, slots, stream);
}

}  // namespace

// Row 11.  x [n, c, h, w], w [co, c, k, k], a, b [co], out [n, co, oh, ow];
// all dense float32 on the device; tile: an index of kTiles; wtap:
// scratch of co * c * k * k floats where k > 1 and c % 32 == 0 (the
// tap-major weights), else unused.
extern "C" cudaError_t conv_bn_act_f32(const float* x, const float* w,
                                       float* wtap, const float* a,
                                       const float* b, float* out, int n,
                                       int c, int h, int wd, int co, int k,
                                       int stride, int pad, int oh, int ow,
                                       int relu, int tile,
                                       cudaStream_t stream) {
  const Shape s{n, c, h, wd, co, k, stride, pad, oh, ow};
  if (x == nullptr || w == nullptr || a == nullptr || b == nullptr ||
      out == nullptr || !shape_ok(n, s) || tile < 0 || tile >= kNumTiles)
    return cudaErrorInvalidValue;
  return conv_launch<false>(tile, x, w, wtap, a, b, out, nullptr, nullptr, s,
                            relu, 1, stream);
}

// Row 12.  wtap as row 11's; conv [n, co, oh, ow]; s, ss [n, co]; part:
// 2 * tiles * slots *
// co floats of scratch, tiles = ceil(n * oh * ow / BN) pixel tiles of
// kTiles[tile] and slots = min(n, ceil((BN - 1) / (oh * ow)) + 1) images
// a tile can touch.
extern "C" cudaError_t conv_stats_f32(const float* x, const float* w,
                                      float* wtap, float* conv, float* part,
                                      float* s,
                                      float* ss, int n, int c, int h, int wd,
                                      int co, int k, int stride, int pad,
                                      int oh, int ow, int tile, int tiles,
                                      int slots, cudaStream_t stream) {
  const Shape sh{n, c, h, wd, co, k, stride, pad, oh, ow};
  if (x == nullptr || w == nullptr || conv == nullptr || part == nullptr ||
      s == nullptr || ss == nullptr || !shape_ok(n, sh) || tile < 0 ||
      tile >= kNumTiles)
    return cudaErrorInvalidValue;
  const int bn = kTiles[tile].bn;
  if (tiles != pixel_tiles(n, sh, bn) || slots != tile_slots(n, sh, bn))
    return cudaErrorInvalidValue;
  float* part_ss = part + (size_t)tiles * slots * co;
  cudaError_t err = conv_launch<true>(tile, x, w, wtap, nullptr, nullptr,
                                      conv, part, part_ss, sh, 0, slots,
                                      stream);
  if (err != cudaSuccess) return err;
  const int rows = n * co;
  stats_reduce_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, part_ss, s, ss, n, co, oh * ow, bn,
                                  slots);
  return cudaGetLastError();
}

// CTAs of the conv kernel one SM holds at once (registers, shared memory
// and threads), for tile `tile`, row 12 (`stats`) or 11, and loader
// `load` (kGather, kVec1x1, kTapMajor); for reports.
extern "C" cudaError_t conv_ctas_per_sm(int tile, int stats, int load,
                                        int* ctas) {
  if (ctas == nullptr || tile < 0 || tile >= kNumTiles || load < 0 ||
      load > kTapMajor)
    return cudaErrorInvalidValue;
  switch (tile * 6 + (stats ? 3 : 0) + load) {
#define CONV_OCC(i, BM, BN, WM, WN)                                   \
  case 6 * i:                                                         \
    return tile_occupancy<BM, BN, WM, WN, false, kGather>(ctas);      \
  case 6 * i + 1:                                                     \
    return tile_occupancy<BM, BN, WM, WN, false, kVec1x1>(ctas);      \
  case 6 * i + 2:                                                     \
    return tile_occupancy<BM, BN, WM, WN, false, kTapMajor>(ctas);    \
  case 6 * i + 3:                                                     \
    return tile_occupancy<BM, BN, WM, WN, true, kGather>(ctas);       \
  case 6 * i + 4:                                                     \
    return tile_occupancy<BM, BN, WM, WN, true, kVec1x1>(ctas);       \
  case 6 * i + 5:                                                     \
    return tile_occupancy<BM, BN, WM, WN, true, kTapMajor>(ctas);
    CONV_OCC(0, 64, 128, 64, 32)
    CONV_OCC(1, 64, 64, 32, 32)
#undef CONV_OCC
  }
  return cudaErrorInvalidValue;
}

// Row 13.  conv, y [total = n * co * plane]; a, b [co].
extern "C" cudaError_t affine_act_f32(const float* conv, const float* a,
                                      const float* b, float* y,
                                      long long total, int co, int plane,
                                      int relu, cudaStream_t stream) {
  if (conv == nullptr || a == nullptr || b == nullptr || y == nullptr ||
      total <= 0 || co <= 0 || plane <= 0 || total % ((long long)co * plane))
    return cudaErrorInvalidValue;
  const long long blocks = (total + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (plane % 4 == 0)
    affine_act_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        conv, a, b, y, total, co, plane, relu);
  else
    affine_act_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        conv, a, b, y, total, co, plane, relu);
  return cudaGetLastError();
}
