// LayerNorm forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/layer_norm.py `_ln_fwd_kernel`
// (launched by `_fwd_pallas`):
//
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta over the last dim of
//   x [R, C], emitting y and the f32 row statistics mean and var (the
//   variance the mean of the centred square, never E[x^2] - mean^2).
//
// Bound: bytes (read x once, write y once, gamma and beta once, 8 bytes
// of statistics per row); at BERT's [1024, 768] 6.3 MB take 0.0019 ms at
// 3.35 TB/s, under the ~0.005 ms a launch takes to reach the card and
// end, so the time is latency: the chain of loads, two warp reductions
// and the store, and how many rows are in flight on the 132 SMs.
// Design:
//   * one warp per row with the row in registers, kRows = 4 rows a CTA
//     of 128 threads: 256 CTAs at 1024 rows on the 132 SMs (2 and 8 rows
//     a CTA timed within 2% of 4 at 614, 1024 and 4096 rows on an H100,
//     PERF.md);
//   * 16-byte loads: lane l holds float4s l, l + 32, ... of the row (6 at
//     C = 768), so every load and store of a warp is coalesced and a lane
//     issues a quarter of the scalar version's load instructions: this is
//     what took [1024, 768] from 0.0103-0.0106 ms to 0.0078-0.0079
//     on an H100 (PERF.md);
//   * gamma and beta are loaded as float4s right after x, before the
//     reductions (loading them after the reductions timed the same);
//   * the row sum: each lane adds its float4s component-wise, folds the
//     four partials as (x + y) + (z + w), and the warp sums the lanes by
//     an xor butterfly (every lane ends with the same sum); the centred
//     squares the same way; one lane stores the statistics;
//   * other rows: C % 4 != 0, a pointer not 16-byte aligned, or C past
//     32 x 4 x 8 = 1024 columns take ln_rows.cuh (scalar loads, eight rows
//     a CTA; past 1024 columns it re-reads the row from L2 for each pass).
//
// The bf16 instantiation (the bf16 AMP policy: the MLM head's LayerNorm
// reads a bf16 activation): x and y bf16, gamma and beta f32 (the f32
// masters of the LN params, which are never carried), f32 statistics and
// mean/var buffers, y = bf16(the f32 expression above), one rounding.
// The same layout: a warp a row, four rows a CTA, lane l holding 16-byte
// chunks l, l + 32, ... of eight bf16 (3 at C = 768) and the two float4
// of gamma and of beta under each; C % 8 != 0, C > 1024 or a pointer not
// 16-byte aligned take a scalar warp-a-row kernel that reads the row from
// device memory for each of its three passes.  Both bf16 kernels spell
// their arithmetic out in round-to-nearest intrinsics (the mean and var
// multiplies, x - mean, the squares' and y's fused multiply-adds), so no
// contraction the compiler may choose moves y: a y that is the small
// difference of its two terms is then exactly the one of
// layer_norm.py's `layer_norm_2d_bf16_kernel_order`, which the card's
// check holds it to within one bf16 ulp.
//
// Entry points: plain C, return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ln_rows.cuh"

namespace {

constexpr int kMaxVec = 8;  // float4s a lane holds: C <= 1024
constexpr int kRows = 4;    // rows (warps) a CTA

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// NV float4s a lane; h4 = C / 4
template <int NV>
__global__ void __launch_bounds__(32 * kRows)
layer_norm_vec_kernel(const float4* __restrict__ x,
                      const float4* __restrict__ gamma,
                      const float4* __restrict__ beta,
                      float4* __restrict__ y, float* __restrict__ mean,
                      float* __restrict__ var, int n, int h4, float inv_h,
                      float eps) {
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * h4;
  float4 v[NV], gv[NV], bv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < h4 ? x[base + c] : zero4();
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    gv[i] = c < h4 ? gamma[c] : zero4();
    bv[i] = c < h4 ? beta[c] : zero4();
  }
  float4 acc = zero4();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc.x += v[i].x;
    acc.y += v[i].y;
    acc.z += v[i].z;
    acc.w += v[i].w;
  }
  const float mu =
      ln_rows::warp_sum((acc.x + acc.y) + (acc.z + acc.w)) * inv_h;
  acc = zero4();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < h4) {
      v[i].x -= mu;
      v[i].y -= mu;
      v[i].z -= mu;
      v[i].w -= mu;
    } else {
      v[i] = zero4();
    }
    acc.x += v[i].x * v[i].x;
    acc.y += v[i].y * v[i].y;
    acc.z += v[i].z * v[i].z;
    acc.w += v[i].w * v[i].w;
  }
  const float var_row =
      ln_rows::warp_sum((acc.x + acc.y) + (acc.z + acc.w)) * inv_h;
  const float rstd = rsqrtf(var_row + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < h4)
      y[base + c] = make_float4(v[i].x * rstd * gv[i].x + bv[i].x,
                                v[i].y * rstd * gv[i].y + bv[i].y,
                                v[i].z * rstd * gv[i].z + bv[i].z,
                                v[i].w * rstd * gv[i].w + bv[i].w);
  }
  if (lane == 0) {
    mean[row] = mu;
    var[row] = var_row;
  }
}

template <int NV>
cudaError_t launch_vec(const float* x, const float* gamma, const float* beta,
                       float* y, float* mean, float* var, int n, int h,
                       float eps, cudaStream_t stream) {
  const int blocks = (n + kRows - 1) / kRows;
  layer_norm_vec_kernel<NV><<<blocks, 32 * kRows, 0, stream>>>(
      reinterpret_cast<const float4*>(x),
      reinterpret_cast<const float4*>(gamma),
      reinterpret_cast<const float4*>(beta), reinterpret_cast<float4*>(y),
      mean, var, n, h / 4, 1.f / (float)h, eps);
  return cudaGetLastError();
}

// the smallest register-holding variant for the row
cudaError_t launch_rows(const float* x, const float* gamma, const float* beta,
                        float* y, float* mean, float* var, int n, int h,
                        float eps, cudaStream_t stream) {
  const int need = (h / 4 + 31) / 32;
  if (need <= 1) return launch_vec<1>(x, gamma, beta, y, mean, var, n, h, eps, stream);
  if (need <= 2) return launch_vec<2>(x, gamma, beta, y, mean, var, n, h, eps, stream);
  if (need <= 3) return launch_vec<3>(x, gamma, beta, y, mean, var, n, h, eps, stream);
  if (need <= 4) return launch_vec<4>(x, gamma, beta, y, mean, var, n, h, eps, stream);
  if (need <= 6) return launch_vec<6>(x, gamma, beta, y, mean, var, n, h, eps, stream);
  return launch_vec<kMaxVec>(x, gamma, beta, y, mean, var, n, h, eps, stream);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// -- bf16 x and y -------------------------------------------------------------

// eight bf16 of one 16-byte chunk as f32: a bf16 is the high half of the f32
// of the same value
__device__ __forceinline__ void widen8(const uint4 a, float* v) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// NV chunks of eight bf16 a lane; h8 = C / 8
template <int NV>
__global__ void __launch_bounds__(32 * kRows)
layer_norm_bf16_vec_kernel(const uint4* __restrict__ x,
                           const float4* __restrict__ gamma,
                           const float4* __restrict__ beta,
                           uint4* __restrict__ y, float* __restrict__ mean,
                           float* __restrict__ var, int n, int h8,
                           float inv_h, float eps) {
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * h8;
  float v[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    widen8(c < h8 ? x[base + c] : make_uint4(0u, 0u, 0u, 0u), v[i]);
  }
  float4 g[NV][2], b[NV][2];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      g[i][k] = c < h8 ? gamma[2 * c + k] : zero4();
      b[i][k] = c < h8 ? beta[2 * c + k] : zero4();
    }
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += v[i][k];
  const float mu = __fmul_rn(
      ln_rows::warp_sum(((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                        ((acc[4] + acc[5]) + (acc[6] + acc[7]))),
      inv_h);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool in = lane + 32 * i < h8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[i][k] = in ? __fsub_rn(v[i][k], mu) : 0.f;
      acc[k] = __fmaf_rn(v[i][k], v[i][k], acc[k]);
    }
  }
  const float var_row = __fmul_rn(
      ln_rows::warp_sum(((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                        ((acc[4] + acc[5]) + (acc[6] + acc[7]))),
      inv_h);
  const float rstd = rsqrtf(__fadd_rn(var_row, eps));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < h8) {
      const float gv[8] = {g[i][0].x, g[i][0].y, g[i][0].z, g[i][0].w,
                           g[i][1].x, g[i][1].y, g[i][1].z, g[i][1].w};
      const float bv[8] = {b[i][0].x, b[i][0].y, b[i][0].z, b[i][0].w,
                           b[i][1].x, b[i][1].y, b[i][1].z, b[i][1].w};
      float o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = __fmaf_rn(__fmul_rn(v[i][k], rstd), gv[k], bv[k]);
      y[base + c] = make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]),
                               pack2(o[4], o[5]), pack2(o[6], o[7]));
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    var[row] = var_row;
  }
}

// any width and alignment: a warp a row, three passes over the row
__global__ void __launch_bounds__(32 * kRows)
layer_norm_bf16_rows_kernel(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            __nv_bfloat16* __restrict__ y,
                            float* __restrict__ mean,
                            float* __restrict__ var, int n, int h,
                            float inv_h, float eps) {
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * h;
  float s = 0.f;
  for (int c = lane; c < h; c += 32) s += __bfloat162float(x[base + c]);
  const float mu = __fmul_rn(ln_rows::warp_sum(s), inv_h);
  s = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float d = __fsub_rn(__bfloat162float(x[base + c]), mu);
    s = __fmaf_rn(d, d, s);
  }
  const float var_row = __fmul_rn(ln_rows::warp_sum(s), inv_h);
  const float rstd = rsqrtf(__fadd_rn(var_row, eps));
  for (int c = lane; c < h; c += 32)
    y[base + c] = __float2bfloat16_rn(__fmaf_rn(
        __fmul_rn(__fsub_rn(__bfloat162float(x[base + c]), mu), rstd),
        gamma[c], beta[c]));
  if (lane == 0) {
    mean[row] = mu;
    var[row] = var_row;
  }
}

template <int NV>
cudaError_t launch_bf16_vec(const void* x, const float* gamma,
                            const float* beta, void* y, float* mean,
                            float* var, int n, int h, float eps,
                            cudaStream_t stream) {
  const int blocks = (n + kRows - 1) / kRows;
  layer_norm_bf16_vec_kernel<NV><<<blocks, 32 * kRows, 0, stream>>>(
      reinterpret_cast<const uint4*>(x),
      reinterpret_cast<const float4*>(gamma),
      reinterpret_cast<const float4*>(beta), reinterpret_cast<uint4*>(y),
      mean, var, n, h / 8, 1.f / (float)h, eps);
  return cudaGetLastError();
}

}  // namespace

// rows the float4 kernel does not take run on ln_rows.cuh's eight-row CTAs
extern "C" cudaError_t layer_norm_fwd_f32(const float* x, const float* gamma,
                                          const float* beta, float* y,
                                          float* mean, float* var, int rows,
                                          int cols, float eps,
                                          cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  const bool vec = cols % 4 == 0 && cols <= 128 * kMaxVec && aligned16(x) &&
                   aligned16(gamma) && aligned16(beta) && aligned16(y);
  if (!vec)
    return ln_rows::launch(x, nullptr, gamma, beta, y, nullptr, mean, var,
                           rows, cols, eps, stream);
  return launch_rows(x, gamma, beta, y, mean, var, rows, cols, eps, stream);
}

// x, y bf16 [rows, cols]; gamma, beta f32 [cols]; mean, var f32 [rows]
extern "C" cudaError_t layer_norm_fwd_bf16(const void* x, const float* gamma,
                                           const float* beta, void* y,
                                           float* mean, float* var, int rows,
                                           int cols, float eps,
                                           cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  const int need = (cols / 8 + 31) / 32;
  const bool vec = cols % 8 == 0 && need <= 4 && aligned16(x) &&
                   aligned16(gamma) && aligned16(beta) && aligned16(y);
  if (!vec) {
    layer_norm_bf16_rows_kernel<<<(rows + kRows - 1) / kRows, 32 * kRows, 0,
                                  stream>>>(
        static_cast<const __nv_bfloat16*>(x), gamma, beta,
        static_cast<__nv_bfloat16*>(y), mean, var, rows, cols,
        1.f / (float)cols, eps);
    return cudaGetLastError();
  }
  if (need <= 1)
    return launch_bf16_vec<1>(x, gamma, beta, y, mean, var, rows, cols, eps,
                              stream);
  if (need <= 2)
    return launch_bf16_vec<2>(x, gamma, beta, y, mean, var, rows, cols, eps,
                              stream);
  if (need <= 3)
    return launch_bf16_vec<3>(x, gamma, beta, y, mean, var, rows, cols, eps,
                              stream);
  return launch_bf16_vec<4>(x, gamma, beta, y, mean, var, rows, cols, eps,
                            stream);
}
