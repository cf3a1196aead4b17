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

#pragma once

#include <cuda_runtime.h>

namespace ln_rows {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y, r may be null (plain LayerNorm: r = x and nothing is stored for it)
template <int NPL>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ z,
               float* __restrict__ r, float* __restrict__ mean,
               float* __restrict__ var, int n, int h, float eps) {
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
        if (y != nullptr) a += y[base + c];
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
      if (y != nullptr) a += y[base + c];
      if (r != nullptr) r[base + c] = a;
      sum += a;
    }
    mu = warp_sum(sum) * inv_h;
    float sq = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float a = x[base + c] + (y != nullptr ? y[base + c] : 0.f) - mu;
      sq += a * a;
    }
    var_row = warp_sum(sq) * inv_h;
    const float rstd = rsqrtf(var_row + eps);
    for (int c = lane; c < h; c += 32) {
      const float a = x[base + c] + (y != nullptr ? y[base + c] : 0.f) - mu;
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
                       cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  ln_rows_kernel<NPL><<<blocks, kThreads, 0, stream>>>(
      x, y, gamma, beta, z, r, mean, var, n, h, eps);
  return cudaGetLastError();
}

// the smallest register-cached variant that holds a row, else the
// re-reading one
inline cudaError_t launch(const float* x, const float* y,
                          const float* gamma, const float* beta, float* z,
                          float* r, float* mean, float* var, int n, int h,
                          float eps, cudaStream_t stream) {
  if (n <= 0 || h <= 0) return cudaErrorInvalidValue;
  const int need = (h + 31) / 32;
  if (need <= 1) return launch_npl<1>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  if (need <= 2) return launch_npl<2>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  if (need <= 4) return launch_npl<4>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  if (need <= 8) return launch_npl<8>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  if (need <= 16) return launch_npl<16>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  if (need <= 24) return launch_npl<24>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  if (need <= 32) return launch_npl<32>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
  return launch_npl<0>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream);
}

}  // namespace ln_rows
