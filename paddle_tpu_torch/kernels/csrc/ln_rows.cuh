// Row-wise LayerNorm shared by fused_ln.cu and layer_norm.cu.
//
// One warp normalises one row of h floats:
//   r = x (+ y),  mean = sum(r) / h,  var = sum((r - mean)^2) / h,
//   z = (r - mean) * rsqrt(var + eps) * gamma + beta,
// with f32 statistics, the variance as the mean of the centred square (as
// the TPU kernels compute it, never E[r^2] - mean^2).  Bound: bytes, one
// read of each input and one write of each output.  With NPL > 0 a lane
// keeps its NPL floats of the row in registers (h <= 32 * NPL), so x and y
// are read once; NPL == 0 is the fallback for wide rows, which re-reads the
// row from device memory (L2) for each of its three passes.  Lane l takes
// elements l, l + 32, ...: every load and store of a warp is coalesced.
//
// Dropout of y (fused_ln.cu at p > 0): with drop.thr != 0,
//   y' = keep ? y * drop.inv_q : 0,  keep = u32 < drop.thr,
// the u32 of element row * h + col of the Philox stream keyed by
// (drop.k0, drop.k1) (philox.cuh), drawn where y is read; a wide row's
// re-reads draw it again.  The draw is a template switch (DROP), so the
// kernels without dropout (p = 0, plain LayerNorm) carry none of its
// code.  Block 0 stores the two key words to seed_out when given (the
// op's Seed output, which the backward replays).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace ln_rows {

struct Drop {
  uint32_t thr = 0u;  // 0: no dropout
  uint32_t k0 = 0u, k1 = 0u;
  float inv_q = 1.f;
};

// y[base + c] after dropout (y non-null)
template <bool DROP>
__device__ __forceinline__ float y_at(const float* __restrict__ y,
                                      size_t base, int c, const Drop& dp) {
  const float v = y[base + c];
  if constexpr (DROP) {
    const bool keep = philox::u32_at(base + c, dp.k0, dp.k1) < dp.thr;
    return keep ? v * dp.inv_q : 0.f;
  } else {
    return v;
  }
}

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y, r may be null (plain LayerNorm: r = x and nothing is stored for it)
template <int NPL, bool DROP>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ z,
               float* __restrict__ r, float* __restrict__ mean,
               float* __restrict__ var, int n, int h, float eps, Drop dp,
               int* __restrict__ seed_out) {
  if (seed_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    seed_out[0] = (int)dp.k0;
    seed_out[1] = (int)dp.k1;
  }
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * h;
  const float inv_h = 1.f / (float)h;
  float mu, var_row;
  if constexpr (NPL > 0) {
    float v[NPL > 0 ? NPL : 1];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      float a = 0.f;
      if (c < h) {
        a = x[base + c];
        if (y != nullptr) a += y_at<DROP>(y, base, c, dp);
        if (r != nullptr) r[base + c] = a;
      }
      v[i] = a;
      sum += a;
    }
    mu = warp_sum(sum) * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const float c = lane + 32 * i < h ? v[i] - mu : 0.f;
      v[i] = c;
      sq += c * c;
    }
    var_row = warp_sum(sq) * inv_h;
    const float rstd = rsqrtf(var_row + eps);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < h) z[base + c] = v[i] * rstd * gamma[c] + beta[c];
    }
  } else {
    float sum = 0.f;
    for (int c = lane; c < h; c += 32) {
      float a = x[base + c];
      if (y != nullptr) a += y_at<DROP>(y, base, c, dp);
      if (r != nullptr) r[base + c] = a;
      sum += a;
    }
    mu = warp_sum(sum) * inv_h;
    float sq = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float a = x[base + c] + (y != nullptr ? y_at<DROP>(y, base, c, dp) : 0.f) - mu;
      sq += a * a;
    }
    var_row = warp_sum(sq) * inv_h;
    const float rstd = rsqrtf(var_row + eps);
    for (int c = lane; c < h; c += 32) {
      const float a = x[base + c] + (y != nullptr ? y_at<DROP>(y, base, c, dp) : 0.f) - mu;
      z[base + c] = a * rstd * gamma[c] + beta[c];
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    var[row] = var_row;
  }
}

template <int NPL>
cudaError_t launch_npl(const float* x, const float* y, const float* gamma,
                       const float* beta, float* z, float* r, float* mean,
                       float* var, int n, int h, float eps,
                       cudaStream_t stream, Drop dp, int* seed_out) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (dp.thr != 0u)
    ln_rows_kernel<NPL, true><<<blocks, kThreads, 0, stream>>>(
        x, y, gamma, beta, z, r, mean, var, n, h, eps, dp, seed_out);
  else
    ln_rows_kernel<NPL, false><<<blocks, kThreads, 0, stream>>>(
        x, y, gamma, beta, z, r, mean, var, n, h, eps, dp, seed_out);
  return cudaGetLastError();
}

// the smallest register-cached variant that holds a row, else the
// re-reading one
inline cudaError_t launch(const float* x, const float* y,
                          const float* gamma, const float* beta, float* z,
                          float* r, float* mean, float* var, int n, int h,
                          float eps, cudaStream_t stream,
                          Drop dp = Drop(), int* seed_out = nullptr) {
  if (n <= 0 || h <= 0) return cudaErrorInvalidValue;
  const int need = (h + 31) / 32;
  if (need <= 1) return launch_npl<1>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 2) return launch_npl<2>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 4) return launch_npl<4>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 8) return launch_npl<8>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 16) return launch_npl<16>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 24) return launch_npl<24>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 32) return launch_npl<32>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  return launch_npl<0>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
}

}  // namespace ln_rows
