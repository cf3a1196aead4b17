// Fused dropout + residual add + LayerNorm for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/fused_ln.py `_fwd_kernel` (launched
// by `_fwd_pallas`), the epilogue of every BERT encoder layer:
//
//   y' = keep ? y * inv_q : 0   (p > 0; y' = y at p = 0)
//   r = x + y',  z = LayerNorm(r) * gamma + beta,
//   emitting z, r and the f32 row statistics mean and var.
//
// The keep draw is the TPU kernel's contract (keep iff u32 < thr, thr =
// round((1 - p) 2^32), inv_q = 2^32 / thr) with the Philox stream of
// philox.cuh in place of the TPU core's generator: element row * h + col,
// keyed by the op's two seed words, which the kernel also stores to the
// op's Seed output for the backward (fused_ln_bwd.cu) to replay.
//
// Bound: bytes.  Per row of h floats it must read x and y and write z and
// r (16 h bytes) plus 8 bytes of statistics, ~0.3 flop per byte, far
// below the card's ridge; at p > 0 one Philox4x32-10 per four elements
// adds ~15 integer operations an element.  At BERT's [4096, 768] that is
// 50.3 MB, 0.015 ms at 3.35 TB/s.  Design, rows of h % 4 == 0 and h <=
// 1024 with 16-byte aligned pointers (BERT's h = 768):
//   * one warp per row with the row in registers, as float4 runs: lane l
//     holds columns 4 (l + 32 i) .. 4 (l + 32 i) + 3, so every load and
//     store is 16 bytes and coalesced;
//   * x, y, gamma and beta are all loaded before the first reduction, so
//     a lane has its whole share of the row in flight at once;
//   * one Philox call per run: elements 4 k .. 4 k + 3 of the stream are
//     the four words of counter k, and the run at column 4 c of row `row`
//     is counter row * h / 4 + c: the same stream, bit for bit, as one
//     draw per element, which the backward's float4 kernel re-draws;
//   * r is stored as soon as it is formed, the kept y rounded after its
//     product (never fused into the add), as the plain version rounds;
//   * the row sum: each lane adds its runs component-wise, folds the four
//     partials as (x + y) + (z + w), and the warp sums the lanes by an xor
//     butterfly; the variance is the mean of the centred square, summed
//     the same way;
//   * kRows = 2 rows (warps) a CTA: 512 CTAs at an encoder batch's 1024
//     rows on the 132 SMs (the scalar kernel's 8 rows a CTA gave 128; 4
//     rows, layer_norm.cu's geometry, timed 1% slower at 1024 rows and
//     the same at 128 and 4096 on an H100, PERF.md).
// Other rows (h % 4 != 0, h > 1024, or a pointer not 16-byte aligned)
// take ln_rows.cuh: scalar loads, a Philox call an element, eight rows a
// CTA, re-reading rows past 1024 columns from L2.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_rows.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxVec = 8;  // float4 runs a lane holds: h <= 1024
constexpr int kRows = 2;    // rows (warps) a CTA

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// NV float4 runs a lane; h4 = h / 4
template <int NV, bool DROP>
__global__ void __launch_bounds__(32 * kRows)
fused_ln_vec_kernel(const float4* __restrict__ x,
                    const float4* __restrict__ y,
                    const float4* __restrict__ gamma,
                    const float4* __restrict__ beta, float4* __restrict__ z,
                    float4* __restrict__ r, float* __restrict__ mean,
                    float* __restrict__ var, int n, int h4, float inv_h,
                    float eps, ln_rows::Drop dp, int* __restrict__ seed_out) {
  if (seed_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    seed_out[0] = (int)dp.k0;
    seed_out[1] = (int)dp.k1;
  }
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const size_t base = (size_t)row * h4;
  float4 v[NV], w[NV], gv[NV], bv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < h4 ? x[base + c] : zero4();
    w[i] = c < h4 ? y[base + c] : zero4();
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
    const int c = lane + 32 * i;
    if (c < h4) {
      float4 d = w[i];
      if constexpr (DROP) {
        // elements 4 (base + c) .. + 3: the four words of one counter
        const uint4 u = philox::group(base + c, dp.k0, dp.k1);
        d.x = u.x < dp.thr ? __fmul_rn(d.x, dp.inv_q) : 0.f;
        d.y = u.y < dp.thr ? __fmul_rn(d.y, dp.inv_q) : 0.f;
        d.z = u.z < dp.thr ? __fmul_rn(d.z, dp.inv_q) : 0.f;
        d.w = u.w < dp.thr ? __fmul_rn(d.w, dp.inv_q) : 0.f;
      }
      v[i].x += d.x;
      v[i].y += d.y;
      v[i].z += d.z;
      v[i].w += d.w;
      r[base + c] = v[i];
    }
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
      z[base + c] = make_float4(v[i].x * rstd * gv[i].x + bv[i].x,
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
cudaError_t launch_vec(const float* x, const float* y, const float* gamma,
                       const float* beta, float* z, float* r, float* mean,
                       float* var, int n, int h, float eps,
                       cudaStream_t stream, ln_rows::Drop dp,
                       int* seed_out) {
  const int blocks = (n + kRows - 1) / kRows;
  const auto f4 = [](const float* p) {
    return reinterpret_cast<const float4*>(p);
  };
  if (dp.thr != 0u)
    fused_ln_vec_kernel<NV, true><<<blocks, 32 * kRows, 0, stream>>>(
        f4(x), f4(y), f4(gamma), f4(beta), reinterpret_cast<float4*>(z),
        reinterpret_cast<float4*>(r), mean, var, n, h / 4, 1.f / (float)h,
        eps, dp, seed_out);
  else
    fused_ln_vec_kernel<NV, false><<<blocks, 32 * kRows, 0, stream>>>(
        f4(x), f4(y), f4(gamma), f4(beta), reinterpret_cast<float4*>(z),
        reinterpret_cast<float4*>(r), mean, var, n, h / 4, 1.f / (float)h,
        eps, dp, seed_out);
  return cudaGetLastError();
}

// the smallest register-holding variant for the row
cudaError_t launch_rows(const float* x, const float* y, const float* gamma,
                        const float* beta, float* z, float* r, float* mean,
                        float* var, int n, int h, float eps,
                        cudaStream_t stream, ln_rows::Drop dp,
                        int* seed_out) {
  const int need = (h / 4 + 31) / 32;
  if (need <= 1) return launch_vec<1>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 2) return launch_vec<2>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 3) return launch_vec<3>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 4) return launch_vec<4>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  if (need <= 6) return launch_vec<6>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
  return launch_vec<kMaxVec>(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream, dp, seed_out);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

// thr == 0: no dropout (k0, k1, inv_q unused); seed_out may be null
extern "C" cudaError_t fused_ln_fwd_f32(const float* x, const float* y,
                                        const float* gamma,
                                        const float* beta, float* z,
                                        float* r, float* mean, float* var,
                                        int n, int h, float eps,
                                        unsigned int thr, unsigned int k0,
                                        unsigned int k1, float inv_q,
                                        int* seed_out, cudaStream_t stream) {
  if (x == nullptr || y == nullptr || r == nullptr || n <= 0 || h <= 0)
    return cudaErrorInvalidValue;
  ln_rows::Drop dp;
  dp.thr = thr;
  dp.k0 = k0;
  dp.k1 = k1;
  dp.inv_q = inv_q;
  const bool vec = h % 4 == 0 && h <= 128 * kMaxVec && aligned16(x) &&
                   aligned16(y) && aligned16(gamma) && aligned16(beta) &&
                   aligned16(z) && aligned16(r);
  if (!vec)
    return ln_rows::launch(x, y, gamma, beta, z, r, mean, var, n, h, eps,
                           stream, dp, seed_out);
  return launch_rows(x, y, gamma, beta, z, r, mean, var, n, h, eps, stream,
                     dp, seed_out);
}
