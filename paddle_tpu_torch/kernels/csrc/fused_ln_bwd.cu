// Backward of the fused residual add + LayerNorm for Hopper (sm_90a),
// float32.
//
// Replaces: paddle_tpu/pallas_kernels/fused_ln.py `_bwd_kernel` (launched
// by `_bwd_pallas`), the training epilogue of every BERT encoder layer.
// From the forward's residual sum r and its f32 row statistics mean and
// var (fused_ln.cu), per row of h:
//
//   xhat = (r - mean) * rsqrt(var + eps),  a = dz * gamma,
//   dr = rsqrt(var + eps) * (a - mean(a) - xhat * mean(a * xhat)),
//   dx = dr,  dy = keep ? dr * inv_q : 0   (at p = 0 dy = dr: the wrapper
//   hands out one tensor and the kernel writes no dy),
//   dgamma = sum over rows of dz * xhat,  dbeta = sum over rows of dz.
//
// The keep mask is the forward's, re-drawn: the same Philox stream
// (philox.cuh) at the same element index row * h + col, keyed by the two
// words of the op's Seed tensor, which each thread reads from device
// memory (the TPU kernel's scalar prefetch; the host never reads it).
//
// Bound: bytes.  It must read r and dz and write dx (12 h bytes a row,
// plus the statistics and the two [h] sums; at p > 0 also dy, 16 h),
// ~1 flop per byte, far below the card's ridge; at p > 0 a Philox call
// per element adds ~50 integer operations an element.  Design:
//   * one warp per row with the row in registers (as ln_rows.cuh): r and
//     dz are read once, xhat and a stay in registers for the write of dx;
//   * each CTA takes a run of rows_per_cta rows; each lane keeps its
//     columns' dgamma / dbeta sums over its warp's rows in registers, the
//     CTA adds its warps' sums in shared memory in a fixed order and
//     writes one [h] partial of each to a [2, n_ctas, h] buffer;
//   * a second kernel adds the n_ctas partials of each column in order:
//     no atomics, so the sums are the same on every run.  The TPU kernel
//     also leaves the partials to a reduction outside it.
// Rows wider than 32 * 32 floats take a variant that keeps the sums in
// shared memory and reads each row twice.
//
// Entry point: plain C, launches both kernels and returns the first
// launch error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// DROP: p > 0 (dy written, the mask re-drawn); without it the kernel
// carries none of the draw's code
template <int NPL, bool DROP>
__global__ void __launch_bounds__(kThreads)
fused_ln_bwd_rows(const float* __restrict__ r, const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ var,
                  const float* __restrict__ dz, float* __restrict__ dx,
                  float* __restrict__ dy, float* __restrict__ part, int n,
                  int h, float eps, int rows_per_cta, uint32_t thr,
                  const int* __restrict__ seed, float inv_q) {
  extern __shared__ float smem[];  // [kWarps][h] dgamma, then dbeta sums
  float* sg = smem;
  float* sb = smem + (size_t)kWarps * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rows_per_cta;
  const int row_end = min(n, row0 + rows_per_cta);
  const float inv_h = 1.f / (float)h;
  uint32_t k0 = 0u, k1 = 0u;
  if constexpr (DROP) {
    k0 = (uint32_t)seed[0];
    k1 = (uint32_t)seed[1];
  }
  // dr of element (base + c) into dx, and its dropout into dy
  auto store = [&](size_t base, int c, float dr) {
    dx[base + c] = dr;
    if constexpr (DROP) {
      const bool keep = philox::u32_at(base + c, k0, k1) < thr;
      dy[base + c] = keep ? dr * inv_q : 0.f;
    }
  };
  if constexpr (NPL > 0) {
    float ag[NPL], ab[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) ag[i] = ab[i] = 0.f;
    for (int row = row0 + warp; row < row_end; row += kWarps) {
      const size_t base = (size_t)row * h;
      const float mu = mean[row];
      const float rstd = rsqrtf(var[row] + eps);
      float xh[NPL], a[NPL];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int c = lane + 32 * i;
        xh[i] = a[i] = 0.f;
        if (c < h) {
          const float d = dz[base + c];
          xh[i] = (r[base + c] - mu) * rstd;
          a[i] = d * gamma[c];
          ag[i] += d * xh[i];
          ab[i] += d;
          s1 += a[i];
          s2 += a[i] * xh[i];
        }
      }
      const float m1 = warp_sum(s1) * inv_h;
      const float m2 = warp_sum(s2) * inv_h;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int c = lane + 32 * i;
        if (c < h) store(base, c, rstd * (a[i] - m1 - xh[i] * m2));
      }
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < h) {
        sg[warp * h + c] = ag[i];
        sb[warp * h + c] = ab[i];
      }
    }
  } else {
    for (int c = lane; c < h; c += 32) sg[warp * h + c] = sb[warp * h + c] = 0.f;
    for (int row = row0 + warp; row < row_end; row += kWarps) {
      const size_t base = (size_t)row * h;
      const float mu = mean[row];
      const float rstd = rsqrtf(var[row] + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < h; c += 32) {
        const float d = dz[base + c];
        const float xh = (r[base + c] - mu) * rstd;
        const float a = d * gamma[c];
        sg[warp * h + c] += d * xh;
        sb[warp * h + c] += d;
        s1 += a;
        s2 += a * xh;
      }
      const float m1 = warp_sum(s1) * inv_h;
      const float m2 = warp_sum(s2) * inv_h;
      for (int c = lane; c < h; c += 32) {
        const float xh = (r[base + c] - mu) * rstd;
        const float a = dz[base + c] * gamma[c];
        store(base, c, rstd * (a - m1 - xh * m2));
      }
    }
  }
  __syncthreads();
  const size_t n_ctas = gridDim.x;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float g = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += sg[w * h + c];
      b += sb[w * h + c];
    }
    part[(size_t)blockIdx.x * h + c] = g;
    part[(n_ctas + blockIdx.x) * h + c] = b;
  }
}

// column c of dgamma / dbeta: the n_ctas partials added in order
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ part, float* __restrict__ dgamma,
                float* __restrict__ dbeta, int n_ctas, int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float g = 0.f, b = 0.f;
  for (int i = 0; i < n_ctas; ++i) {
    g += part[(size_t)i * h + c];
    b += part[((size_t)n_ctas + i) * h + c];
  }
  dgamma[c] = g;
  dbeta[c] = b;
}

template <int NPL, bool DROP>
cudaError_t launch_drop(const float* r, const float* gamma, const float* mean,
                        const float* var, const float* dz, float* dx,
                        float* dy, float* part, int n, int h, float eps,
                        int rows_per_cta, int n_ctas, uint32_t thr,
                        const int* seed, float inv_q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kWarps * (size_t)h;
  if (smem > kDefaultSmem) {  // wide rows only: BERT's h = 768 needs 24 KB
    const cudaError_t err = cudaFuncSetAttribute(
        fused_ln_bwd_rows<NPL, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_ln_bwd_rows<NPL, DROP><<<n_ctas, kThreads, smem, stream>>>(
      r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, thr,
      seed, inv_q);
  return cudaGetLastError();
}

// dy == nullptr: no dropout
template <int NPL>
cudaError_t launch_rows(const float* r, const float* gamma, const float* mean,
                        const float* var, const float* dz, float* dx,
                        float* dy, float* part, int n, int h, float eps,
                        int rows_per_cta, int n_ctas, uint32_t thr,
                        const int* seed, float inv_q, cudaStream_t stream) {
  if (dy != nullptr)
    return launch_drop<NPL, true>(r, gamma, mean, var, dz, dx, dy, part, n,
                                  h, eps, rows_per_cta, n_ctas, thr, seed,
                                  inv_q, stream);
  return launch_drop<NPL, false>(r, gamma, mean, var, dz, dx, dy, part, n, h,
                                 eps, rows_per_cta, n_ctas, thr, seed, inv_q,
                                 stream);
}

cudaError_t launch_any(const float* r, const float* gamma, const float* mean,
                       const float* var, const float* dz, float* dx,
                       float* dy, float* part, int n, int h, float eps,
                       int rows_per_cta, int n_ctas, uint32_t thr,
                       const int* seed, float inv_q, cudaStream_t stream) {
  const int need = (h + 31) / 32;
  if (need <= 1) return launch_rows<1>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 2) return launch_rows<2>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 4) return launch_rows<4>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 8) return launch_rows<8>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 16) return launch_rows<16>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 24) return launch_rows<24>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 32) return launch_rows<32>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  return launch_rows<0>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
}

}  // namespace

// part: [2, n_ctas, h] scratch; rows_per_cta * n_ctas must cover n.
// thr == 0: no dropout, dy and seed unused (may be null); else dy gets
// the dropped gradient and seed points at the op's two int32 seed words
// on the device.
extern "C" cudaError_t fused_ln_bwd_f32(const float* r, const float* gamma,
                                        const float* mean, const float* var,
                                        const float* dz, float* dx, float* dy,
                                        float* part, float* dgamma,
                                        float* dbeta, int n, int h,
                                        float eps, int rows_per_cta,
                                        int n_ctas, unsigned int thr,
                                        const int* seed, float inv_q,
                                        cudaStream_t stream) {
  if (r == nullptr || dz == nullptr || dx == nullptr || part == nullptr ||
      n <= 0 || h <= 0 || rows_per_cta <= 0 || n_ctas <= 0 ||
      (long long)rows_per_cta * n_ctas < n ||
      (long long)rows_per_cta * (n_ctas - 1) >= n ||
      (thr != 0u && (dy == nullptr || seed == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_any(r, gamma, mean, var, dz, dx,
                               thr != 0u ? dy : nullptr, part, n, h, eps,
                               rows_per_cta, n_ctas, thr, seed, inv_q,
                               stream);
  if (err != cudaSuccess) return err;
  reduce_partials<<<(h + 255) / 256, 256, 0, stream>>>(part, dgamma, dbeta,
                                                       n_ctas, h);
  return cudaGetLastError();
}
