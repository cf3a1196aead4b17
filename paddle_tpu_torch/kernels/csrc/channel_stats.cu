// Column statistics of a bf16 [M, C] matrix for Hopper (sm_90a): the
// batch-norm statistics pass in the channels-last view of a conv output.
//
// Replaces: tools/bench_reduce_pallas.py
//   * row 16, `_stats_kernel` (launched by `pallas_stats_one`):
//       s = sum over rows of (x + c), ss = sum of (x + c)^2, in f32, for a
//       scalar c (`channel_stats_bf16`);
//   * row 17, `_affine_stats_kernel` (launched by `pallas_affine_stats`):
//       y = x a + b in f32, written as bf16, and the column sum and sum of
//       squares of y, taken over the f32 values before the bf16 store
//       (`affine_stats_bf16`).
// The TPU kernels walk row blocks in order and carry the sums in their
// (1, C) output blocks across the grid.
//
// Here CTAs own slabs of rows, in parallel.  Each thread owns 8 adjacent
// columns, read as one 16-byte load of 8 bf16 (C / 8 threads cover a row,
// 256 / (C / 8) rows are in flight per CTA step), and keeps their 16 sums
// in registers; kUnroll rows' loads are issued before any is added.  A CTA
// sums its threads' registers per column in row-lane order through shared
// memory into partials [blocks, C]; a second kernel reduces each column's
// partials with one warp in a fixed order (strided lane sums, then a fixed
// shuffle tree).  No float atomics: a run repeats bit for bit, and any M
// works, the tail slab included.  y's multiply and add are explicitly
// rounded intrinsics (never contracted into an FMA), so y is bitwise the
// plain version's (x.float() * a + b).to(bfloat16).
//
// Bound: bytes.  Row 16 reads x once (M C 2 bytes); row 17 reads x and
// writes y (2 M C 2 bytes); the sums are ~4 flops an element, far below
// the f32 rate.
//
// Entry points: plain C, each returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte row loads in flight per thread

struct Acc {
  float s[8], ss[8];
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16_rn(f[2 * i]),
                              __float2bfloat16_rn(f[2 * i + 1]));
  return v;
}

// kAffine false: row 16 (shift by *c); true: row 17 (y = x a + b, stored).
template <bool kAffine>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const uint4* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ a, const float* __restrict__ b,
                     uint4* __restrict__ y, float* __restrict__ part_s,
                     float* __restrict__ part_ss, long long m, int ch) {
  __shared__ float sh_s[kThreads * 8];
  __shared__ float sh_ss[kThreads * 8];
  const int tpr = ch / 8;           // threads per row
  const int rpi = kThreads / tpr;   // rows per CTA step
  const int g = threadIdx.x % tpr;  // column group: columns [8 g, 8 g + 8)
  const int lane_row = threadIdx.x / tpr;
  const bool active = lane_row < rpi;
  long long per = (m + gridDim.x - 1) / gridDim.x;
  per = (per + rpi - 1) / rpi * rpi;
  const long long r0 = (long long)blockIdx.x * per;
  const long long r1 = min(m, r0 + per);

  float sa[8], sb[8], shift = 0.f;
  if (kAffine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[j] = active ? a[8 * g + j] : 0.f;
      sb[j] = active ? b[8 * g + j] : 0.f;
    }
  } else {
    shift = *c;
  }
  Acc acc;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc.s[j] = acc.ss[j] = 0.f;

  if (active) {
    for (long long row = r0 + lane_row; row < r1;
         row += (long long)kUnroll * rpi) {
      uint4 v[kUnroll];
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const long long rr = row + (long long)t * rpi;
        if (rr < r1) v[t] = x[rr * tpr + g];
      }
#pragma unroll
      for (int t = 0; t < kUnroll; ++t) {
        const long long rr = row + (long long)t * rpi;
        if (rr >= r1) break;
        float f[8];
        unpack(v[t], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[j] = kAffine ? __fadd_rn(__fmul_rn(f[j], sa[j]), sb[j])
                         : __fadd_rn(f[j], shift);
          acc.s[j] = __fadd_rn(acc.s[j], f[j]);
          acc.ss[j] = __fadd_rn(acc.ss[j], __fmul_rn(f[j], f[j]));
        }
        if (kAffine) y[rr * tpr + g] = pack(f);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sh_s[threadIdx.x * 8 + j] = acc.s[j];
    sh_ss[threadIdx.x * 8 + j] = acc.ss[j];
  }
  __syncthreads();
  // column col is slot col % 8 of the threads (r, col / 8), at
  // sh[r * ch + col], summed over the row lanes r in order
  for (int col = threadIdx.x; col < ch; col += kThreads) {
    float s = 0.f, ss = 0.f;
    for (int r = 0; r < rpi; ++r) {
      s = __fadd_rn(s, sh_s[r * ch + col]);
      ss = __fadd_rn(ss, sh_ss[r * ch + col]);
    }
    part_s[(size_t)blockIdx.x * ch + col] = s;
    part_ss[(size_t)blockIdx.x * ch + col] = ss;
  }
}

// One warp per column: lane l sums partials l, l + 32, ... in order, then
// a fixed shuffle tree adds the lanes.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ part_s,
                    const float* __restrict__ part_ss, float* __restrict__ s,
                    float* __restrict__ ss, int blocks, int ch) {
  const int col = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= ch) return;
  float a = 0.f, q = 0.f;
  for (int i = lane; i < blocks; i += 32) {
    a = __fadd_rn(a, part_s[(size_t)i * ch + col]);
    q = __fadd_rn(q, part_ss[(size_t)i * ch + col]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, off));
  }
  if (lane == 0) {
    s[col] = a;
    ss[col] = q;
  }
}

bool shape_ok(long long m, int ch, int blocks, const void* x) {
  return x != nullptr && m > 0 && ch >= 8 && ch % 8 == 0 && ch / 8 <= kThreads &&
         blocks > 0 && blocks <= 65535 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

cudaError_t reduce(const float* part, float* s, float* ss, int blocks, int ch,
                   cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = kThreads / 32;
  stats_reduce_kernel<<<(ch + warps - 1) / warps, kThreads, 0, stream>>>(
      part, part + (size_t)blocks * ch, s, ss, blocks, ch);
  return cudaGetLastError();
}

}  // namespace

// Row 16.  x [m, ch] bf16, c [1] f32; part: 2 * blocks * ch floats of
// scratch; s, ss [ch] f32.  All dense on the device.
extern "C" cudaError_t channel_stats_bf16(const void* x, const float* c,
                                          float* part, float* s, float* ss,
                                          long long m, int ch, int blocks,
                                          cudaStream_t stream) {
  if (c == nullptr || part == nullptr || s == nullptr || ss == nullptr ||
      !shape_ok(m, ch, blocks, x))
    return cudaErrorInvalidValue;
  stats_partial_kernel<false><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(x), c, nullptr, nullptr, nullptr, part,
      part + (size_t)blocks * ch, m, ch);
  return reduce(part, s, ss, blocks, ch, stream);
}

// Row 17.  x, y [m, ch] bf16, a, b [ch] f32; part, s, ss as row 16.
extern "C" cudaError_t affine_stats_bf16(const void* x, const float* a,
                                         const float* b, void* y,
                                         float* part, float* s, float* ss,
                                         long long m, int ch, int blocks,
                                         cudaStream_t stream) {
  if (a == nullptr || b == nullptr || part == nullptr || s == nullptr ||
      ss == nullptr || !shape_ok(m, ch, blocks, x) ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  stats_partial_kernel<true><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(x), nullptr, a, b,
      reinterpret_cast<uint4*>(y), part, part + (size_t)blocks * ch, m, ch);
  return reduce(part, s, ss, blocks, ch, stream);
}
