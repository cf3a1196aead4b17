// The conv + batch-norm + relu block for Hopper (sm_90a), NCHW float32:
// three kernels over one implicit-GEMM conv core.
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
// The conv core.  Per image the conv is the product
//   out[co, p] = sum_k W[co, k] * X[k, p],  k = (c, r, s) over C * kh * kw,
// p = (oh, ow) over OH * OW, where X[k, p] = x[c, oh*stride - pad + r,
// ow*stride - pad + s] (zero outside the image) is gathered on the fly,
// never written out (implicit GEMM).  A CTA of 256 threads owns a 64 x 64
// tile (64 output channels x 64 output pixels of ONE image, so a tile's
// channel partials belong to one image, as row 12's contract wants; at
// ResNet's stage 5, OH * OW = 49, one partial tile per image).  It walks K
// in slices of 16: the weight slice [64 x 16] and the gathered input slice
// [16 x 64] are staged through shared memory, and each thread accumulates
// a 4 x 4 block of the tile in f32 FMA registers.  The next slice's global
// loads are issued into registers before the current slice's FMAs (a
// register double buffer), so their latency hides under the arithmetic.
//
// Bound: operations at the main path's shapes (a ResNet-50 3x3 conv at
// 14 x 14 does ~2300 flops per byte it must move); the TPU kernel's
// kh * kw shifted matmuls on the MXU become f32 FMAs on the SIMT pipes
// here (67 TF/s f32 on an H100 SXM).  `wgmma` on bf16 or TF32 operands is
// later work: the port's f32 contract keeps TF32 off.
//
// Row 12's statistics.  Each CTA reduces its tile's conv values per
// channel (4 pixels in registers, then 16 lanes by a fixed shuffle tree)
// into partials[image, pixel tile, channel]; a second small kernel sums
// the pixel tiles of each (image, channel) in order.  No float atomics:
// card runs repeat bit for bit.  The host folds the batch statistics as
// the reference does (v = E[x^2] - m^2).
//
// Row 13 is a pass over memory: bound by bytes (read the conv, write y).
// Its multiply and add are explicitly rounded intrinsics, never contracted
// into an FMA, so it is bitwise the plain version's conv * a + b.
//
// Entry points: plain C, each returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileCo = 64;   // output channels per CTA
constexpr int kTilePix = 64;  // output pixels per CTA, of one image
constexpr int kSlice = 16;    // reduction slice staged per step
constexpr int kPad = 4;       // shared row padding (keeps float4 alignment)

struct Shape {
  int c, h, w, co, k, stride, pad, oh, ow;
};

// Register-staged global loads of one K slice: 4 weights (one output
// channel, 4 consecutive k) and 4 gathered inputs (4 k, one pixel).
struct Stage {
  float a[4];
  float b[4];
};

__device__ __forceinline__ void load_slice(const float* __restrict__ xi,
                                           const float* __restrict__ wt,
                                           const Shape& s, int K, int k0,
                                           int co0, int a_row, int a_col,
                                           int b_k, int pix_ok, int ih0,
                                           int iw0, Stage& st) {
  const int co = co0 + a_row;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = k0 + a_col + j;
    st.a[j] = (co < s.co && kk < K) ? __ldg(wt + (size_t)co * K + kk) : 0.f;
  }
  const int kk2 = s.k * s.k;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = k0 + b_k + j;
    float v = 0.f;
    if (pix_ok && kk < K) {
      const int c = kk / kk2;
      const int rem = kk - c * kk2;
      const int r = rem / s.k;
      const int ih = ih0 + r;
      const int iw = iw0 + (rem - r * s.k);
      if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
        v = __ldg(xi + ((size_t)c * s.h + ih) * s.w + iw);
    }
    st.b[j] = v;
  }
}

// kStats false: row 11, out = act(acc * a + b).
// kStats true: row 12, out = acc, and the tile's channel partials.
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
            const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, float* __restrict__ part_s,
            float* __restrict__ part_ss, Shape s, int relu) {
  __shared__ __align__(16) float As[kSlice][kTileCo + kPad];
  __shared__ __align__(16) float Bs[kSlice][kTilePix + kPad];

  const int tid = threadIdx.x;
  const int img = blockIdx.z;
  const int co0 = blockIdx.y * kTileCo;
  const int p0 = blockIdx.x * kTilePix;
  const int P = s.oh * s.ow;
  const int K = s.c * s.k * s.k;
  const float* xi = x + (size_t)img * s.c * s.h * s.w;

  // loader roles
  const int a_row = tid >> 2;         // 0..63: output channel in the tile
  const int a_col = (tid & 3) * 4;    // 0, 4, 8, 12: k in the slice
  const int b_pix = tid & 63;         // pixel in the tile
  const int b_k = (tid >> 6) * 4;     // 0, 4, 8, 12: k in the slice
  const int p = p0 + b_pix;
  const int pix_ok = p < P;
  const int oh = pix_ok ? p / s.ow : 0;
  const int ow = pix_ok ? p - oh * s.ow : 0;
  const int ih0 = oh * s.stride - s.pad;
  const int iw0 = ow * s.stride - s.pad;

  // compute roles: 4 channels x 4 consecutive pixels
  const int ty = tid >> 4;  // 0..15
  const int tx = tid & 15;  // 0..15

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Stage st;
  load_slice(xi, wt, s, K, 0, co0, a_row, a_col, b_k, pix_ok, ih0, iw0, st);
  for (int k0 = 0; k0 < K; k0 += kSlice) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[a_col + j][a_row] = st.a[j];
      Bs[b_k + j][b_pix] = st.b[j];
    }
    __syncthreads();
    if (k0 + kSlice < K)
      load_slice(xi, wt, s, K, k0 + kSlice, co0, a_row, a_col, b_k, pix_ok,
                 ih0, iw0, st);
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* oi = out + (size_t)img * s.co * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    float sum = 0.f, sq = 0.f;
    if (co < s.co) {
      float scale = 1.f, shift = 0.f;
      if (!kStats) {
        scale = a[co];
        shift = b[co];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pj = p0 + tx * 4 + j;
        if (pj < P) {
          const float v = acc[i][j];
          if (kStats) {
            oi[(size_t)co * P + pj] = v;
            sum += v;
            sq += v * v;
          } else {
            float y = v * scale + shift;
            if (relu) y = fmaxf(y, 0.f);
            oi[(size_t)co * P + pj] = y;
          }
        }
      }
    }
    if (kStats) {
      // the 16 lanes of one row of threads hold the tile's 64 pixels of
      // this channel: a fixed shuffle tree, so the sum order never varies
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (tx == 0 && co < s.co) {
        const size_t at = ((size_t)img * gridDim.x + blockIdx.x) * s.co + co;
        part_s[at] = sum;
        part_ss[at] = sq;
      }
    }
  }
}

// Sum the pixel tiles' partials of each (image, channel) in tile order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ part_s,
                    const float* __restrict__ part_ss, float* __restrict__ s,
                    float* __restrict__ ss, int n, int co, int tiles) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * co) return;
  const int img = i / co;
  const int c = i - img * co;
  float a = 0.f, b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const size_t at = ((size_t)img * tiles + t) * co + c;
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
  return n > 0 && n <= 65535 && s.c > 0 && s.h > 0 && s.w > 0 && s.co > 0 &&
         s.k > 0 && s.stride > 0 && s.pad >= 0 && s.oh > 0 && s.ow > 0 &&
         s.oh == (s.h + 2 * s.pad - s.k) / s.stride + 1 &&
         s.ow == (s.w + 2 * s.pad - s.k) / s.stride + 1 &&
         (s.co + kTileCo - 1) / kTileCo <= 65535;
}

dim3 conv_grid(int n, const Shape& s) {
  return dim3((unsigned)((s.oh * s.ow + kTilePix - 1) / kTilePix),
              (unsigned)((s.co + kTileCo - 1) / kTileCo), (unsigned)n);
}

}  // namespace

// Row 11.  x [n, c, h, w], w [co, c, k, k], a, b [co], out [n, co, oh, ow];
// all dense float32 on the device.
extern "C" cudaError_t conv_bn_act_f32(const float* x, const float* w,
                                       const float* a, const float* b,
                                       float* out, int n, int c, int h,
                                       int wd, int co, int k, int stride,
                                       int pad, int oh, int ow, int relu,
                                       cudaStream_t stream) {
  const Shape s{c, h, wd, co, k, stride, pad, oh, ow};
  if (x == nullptr || w == nullptr || a == nullptr || b == nullptr ||
      out == nullptr || !shape_ok(n, s))
    return cudaErrorInvalidValue;
  conv_kernel<false><<<conv_grid(n, s), kThreads, 0, stream>>>(
      x, w, a, b, out, nullptr, nullptr, s, relu);
  return cudaGetLastError();
}

// Row 12.  conv [n, co, oh, ow]; part: 2 * n * tiles * co floats of scratch
// (tiles = ceil(oh * ow / 64)); s, ss [n, co].
extern "C" cudaError_t conv_stats_f32(const float* x, const float* w,
                                      float* conv, float* part, float* s,
                                      float* ss, int n, int c, int h, int wd,
                                      int co, int k, int stride, int pad,
                                      int oh, int ow, int tiles,
                                      cudaStream_t stream) {
  const Shape sh{c, h, wd, co, k, stride, pad, oh, ow};
  if (x == nullptr || w == nullptr || conv == nullptr || part == nullptr ||
      s == nullptr || ss == nullptr || !shape_ok(n, sh) ||
      tiles != (oh * ow + kTilePix - 1) / kTilePix)
    return cudaErrorInvalidValue;
  float* part_ss = part + (size_t)n * tiles * co;
  conv_kernel<true><<<conv_grid(n, sh), kThreads, 0, stream>>>(
      x, w, nullptr, nullptr, conv, part, part_ss, sh, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = n * co;
  stats_reduce_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, part_ss, s, ss, n, co, tiles);
  return cudaGetLastError();
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
