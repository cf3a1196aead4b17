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
// ~1 flop per byte, far below the card's ridge; at p > 0 a Philox group
// per four elements adds ~15 integer operations an element.  At BERT's
// [4096, 768] on an H100, adding the partials on 3 CTAs took ~0.015 ms of
// 0.039-0.052, and a Philox group drawn per element most of p > 0's extra
// time (PERF.md).  Design, rows of h % 4 == 0 and h <= 1024:
//   * one warp per row with the row in registers, as float4 runs: lane l
//     holds columns 4 (l + 32 i) .. 4 (l + 32 i) + 3, 16-byte loads of r,
//     dz and gamma and 16-byte stores of dx and dy;
//   * one Philox call per run: elements 4 k .. 4 k + 3 of the stream are
//     the four words of counter k, and the run at column 4 c of row `row`
//     is counter row * h / 4 + c, so the mask is bit for bit the
//     forward's;
//   * each warp adds its rows' dz * xhat and dz into its own [h] slice of
//     shared memory (not registers: ~100 registers a thread let 4 CTAs of
//     4 warps share an SM); the CTA adds its warps' slices in a fixed
//     order and writes one [h] partial of each sum to [2, n_ctas, h];
//   * a second kernel adds the partials: a CTA takes 32 columns, its
//     threads split the n_ctas partials 32 ways, each adding its share in
//     order, and the 32 shares are added in a fixed tree.  No atomics, so
//     the sums are the same bits on every run.  The TPU kernel also leaves
//     the partials to a reduction outside it.
// Other rows (h % 4 != 0, h > 1024, or a pointer not 16-byte aligned)
// take the scalar kernel, a lane columns l + 32 i and a Philox call an
// element; rows wider than 32 * 32 floats keep the sums in shared memory
// and read each row twice.  Its partials go through the same reduction,
// in floats.
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

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// NV float4 runs a lane; h4 = h / 4
template <int NV, bool DROP>
__global__ void __launch_bounds__(kThreads, 4)
fused_ln_bwd_vec(const float4* __restrict__ r,
                 const float4* __restrict__ gamma,
                 const float* __restrict__ mean,
                 const float* __restrict__ var,
                 const float4* __restrict__ dz, float4* __restrict__ dx,
                 float4* __restrict__ dy, float4* __restrict__ part, int n,
                 int h4, float inv_h, float eps, int rows_per_cta,
                 uint32_t thr, const int* __restrict__ seed, float inv_q) {
  extern __shared__ float4 smem4[];  // [kWarps][h4] dgamma, then dbeta
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* sg = smem4 + (size_t)warp * h4;
  float4* sb = smem4 + (size_t)(kWarps + warp) * h4;
  const int row0 = blockIdx.x * rows_per_cta;
  const int row_end = min(n, row0 + rows_per_cta);
  uint32_t k0 = 0u, k1 = 0u;
  if constexpr (DROP) {
    k0 = (uint32_t)seed[0];
    k1 = (uint32_t)seed[1];
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < h4) sg[c] = sb[c] = zero4();
  }
  for (int row = row0 + warp; row < row_end; row += kWarps) {
    const size_t base = (size_t)row * h4;
    const float mu = mean[row];
    const float rstd = rsqrtf(var[row] + eps);
    float4 xh[NV], a[NV];  // r and dz as loaded, then xhat and dz * gamma
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      xh[i] = c < h4 ? r[base + c] : zero4();
      a[i] = c < h4 ? dz[base + c] : zero4();
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < h4) {
        const float4 g = gamma[c];
        const float4 d = a[i];
        float4 x = xh[i];
        x.x = (x.x - mu) * rstd;
        x.y = (x.y - mu) * rstd;
        x.z = (x.z - mu) * rstd;
        x.w = (x.w - mu) * rstd;
        xh[i] = x;
        a[i] = make_float4(d.x * g.x, d.y * g.y, d.z * g.z, d.w * g.w);
        add_to(sg[c], make_float4(d.x * x.x, d.y * x.y, d.z * x.z,
                                  d.w * x.w));
        add_to(sb[c], d);
        s1 += (a[i].x + a[i].y) + (a[i].z + a[i].w);
        s2 += (a[i].x * x.x + a[i].y * x.y) + (a[i].z * x.z + a[i].w * x.w);
      }
    }
    const float m1 = warp_sum(s1) * inv_h;
    const float m2 = warp_sum(s2) * inv_h;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < h4) {
        const float4 dr =
            make_float4(rstd * (a[i].x - m1 - xh[i].x * m2),
                        rstd * (a[i].y - m1 - xh[i].y * m2),
                        rstd * (a[i].z - m1 - xh[i].z * m2),
                        rstd * (a[i].w - m1 - xh[i].w * m2));
        dx[base + c] = dr;
        if constexpr (DROP) {
          // elements 4 (base + c) .. + 3: the four words of one counter
          const uint4 u = philox::group(base + c, k0, k1);
          dy[base + c] = make_float4(u.x < thr ? dr.x * inv_q : 0.f,
                                     u.y < thr ? dr.y * inv_q : 0.f,
                                     u.z < thr ? dr.z * inv_q : 0.f,
                                     u.w < thr ? dr.w * inv_q : 0.f);
        }
      }
    }
  }
  __syncthreads();
  const size_t n_ctas = gridDim.x;
  for (int c = threadIdx.x; c < h4; c += kThreads) {
    float4 g = zero4(), b = zero4();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      add_to(g, smem4[(size_t)w * h4 + c]);
      add_to(b, smem4[(size_t)(kWarps + w) * h4 + c]);
    }
    part[(size_t)blockIdx.x * h4 + c] = g;
    part[(n_ctas + blockIdx.x) * h4 + c] = b;
  }
}

// dgamma (blockIdx.y 0) or dbeta (1) of COLS columns of V: the n_ctas
// partials split SLICES ways, slice k adding partials k, k + SLICES, ...
// in order, then the slices added in a fixed tree
template <typename V, int COLS, int SLICES>
__global__ void __launch_bounds__(COLS * SLICES)
reduce_partials(const V* __restrict__ part, V* __restrict__ dgamma,
                V* __restrict__ dbeta, int n_ctas, int hv) {
  __shared__ V s[SLICES][COLS];
  const int cx = threadIdx.x % COLS;
  const int sl = threadIdx.x / COLS;
  const int c = blockIdx.x * COLS + cx;
  const V* p = part + (size_t)blockIdx.y * n_ctas * hv;
  V acc = V();
  if (c < hv) {
#pragma unroll 4
    for (int i = sl; i < n_ctas; i += SLICES) add_to(acc, p[(size_t)i * hv + c]);
  }
  s[sl][cx] = acc;
  __syncthreads();
#pragma unroll
  for (int st = SLICES / 2; st > 0; st >>= 1) {
    if (sl < st) add_to(s[sl][cx], s[sl + st][cx]);
    __syncthreads();
  }
  if (sl == 0 && c < hv) (blockIdx.y == 0 ? dgamma : dbeta)[c] = s[0][cx];
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

template <int NV, bool DROP>
cudaError_t launch_vec(const float* r, const float* gamma, const float* mean,
                       const float* var, const float* dz, float* dx,
                       float* dy, float* part, int n, int h, float eps,
                       int rows_per_cta, int n_ctas, uint32_t thr,
                       const int* seed, float inv_q, cudaStream_t stream) {
  // 2 x 4 warps x h floats: 24 KB at h = 768, 32 KB at the widest
  const size_t smem = sizeof(float) * 2 * kWarps * (size_t)h;
  fused_ln_bwd_vec<NV, DROP><<<n_ctas, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(r),
      reinterpret_cast<const float4*>(gamma), mean, var,
      reinterpret_cast<const float4*>(dz), reinterpret_cast<float4*>(dx),
      reinterpret_cast<float4*>(dy), reinterpret_cast<float4*>(part), n,
      h / 4, 1.f / (float)h, eps, rows_per_cta, thr, seed, inv_q);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_vec_drop(const float* r, const float* gamma,
                            const float* mean, const float* var,
                            const float* dz, float* dx, float* dy,
                            float* part, int n, int h, float eps,
                            int rows_per_cta, int n_ctas, uint32_t thr,
                            const int* seed, float inv_q,
                            cudaStream_t stream) {
  if (dy != nullptr)
    return launch_vec<NV, true>(r, gamma, mean, var, dz, dx, dy, part, n, h,
                                eps, rows_per_cta, n_ctas, thr, seed, inv_q,
                                stream);
  return launch_vec<NV, false>(r, gamma, mean, var, dz, dx, dy, part, n, h,
                               eps, rows_per_cta, n_ctas, thr, seed, inv_q,
                               stream);
}

// the smallest register-holding float4 variant for the row
cudaError_t launch_vec_any(const float* r, const float* gamma,
                           const float* mean, const float* var,
                           const float* dz, float* dx, float* dy,
                           float* part, int n, int h, float eps,
                           int rows_per_cta, int n_ctas, uint32_t thr,
                           const int* seed, float inv_q,
                           cudaStream_t stream) {
  const int need = (h / 4 + 31) / 32;
  if (need <= 1) return launch_vec_drop<1>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 2) return launch_vec_drop<2>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 3) return launch_vec_drop<3>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 4) return launch_vec_drop<4>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  if (need <= 6) return launch_vec_drop<6>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
  return launch_vec_drop<8>(r, gamma, mean, var, dz, dx, dy, part, n, h, eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

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
  float* dy_or_null = thr != 0u ? dy : nullptr;
  const bool vec = h % 4 == 0 && h <= 1024 && aligned16(r) &&
                   aligned16(gamma) && aligned16(dz) && aligned16(dx) &&
                   aligned16(part) && aligned16(dgamma) &&
                   aligned16(dbeta) &&
                   (dy_or_null == nullptr || aligned16(dy_or_null));
  if (vec) {
    const cudaError_t err =
        launch_vec_any(r, gamma, mean, var, dz, dx, dy_or_null, part, n, h,
                       eps, rows_per_cta, n_ctas, thr, seed, inv_q, stream);
    if (err != cudaSuccess) return err;
    const int h4 = h / 4;
    reduce_partials<float4, 8, 32><<<dim3((h4 + 7) / 8, 2), 256, 0,
                                     stream>>>(
        reinterpret_cast<const float4*>(part),
        reinterpret_cast<float4*>(dgamma), reinterpret_cast<float4*>(dbeta),
        n_ctas, h4);
    return cudaGetLastError();
  }
  const cudaError_t err = launch_any(r, gamma, mean, var, dz, dx, dy_or_null,
                                     part, n, h, eps, rows_per_cta, n_ctas,
                                     thr, seed, inv_q, stream);
  if (err != cudaSuccess) return err;
  reduce_partials<float, 32, 8><<<dim3((h + 31) / 32, 2), 256, 0, stream>>>(
      part, dgamma, dbeta, n_ctas, h);
  return cudaGetLastError();
}
