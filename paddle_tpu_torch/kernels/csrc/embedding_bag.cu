// The embedding bag for Hopper (sm_90a): out[b] = sum_k rows[ids[b, k]]
// over the ids >= 0 of each bag, float32, added in k order.
//
// Replaces: paddle_tpu/pallas_kernels/embedding_bag.py, row 15,
// `_bag_kernel` (launched by `_bag_pallas`).  The TPU kernel walks a
// (bag, k) grid in order, its scalar-prefetched ids steering one (1, D)
// row DMA per step into a VMEM accumulator, so the [B, K, D] gather never
// reaches device memory; a pad (-1) is clamped to row 0 for the DMA and
// added as 0.0.
//
// Here one warp owns one bag.  The grid has no order, so the k loop runs
// inside the warp: lane l holds columns [4 l, 4 l + 4) of a 128-column
// chunk in a float4 register accumulator, and one 16-byte load per lane
// reads a 128-wide f32 row as one coalesced 512-byte request.  D is walked
// in chunks of 128.  The warp reads 32 of its bag's ids at once (int64, the
// feed's dtype; one per lane) and broadcasts each by a shuffle; the rows of
// kUnroll ids are loaded before any of them is added, so each warp keeps
// that many row reads in flight.  The adds run in k order, each an IEEE
// add (never contracted), with +0.0 added for a pad as the TPU kernel's
// jnp.where(valid, row, 0.0) does: the result is bitwise the plain
// version's (kernels/embedding_bag.py `embedding_bag_reference`).  A pad
// reads no row.  An id >= U is outside the contract (the plain version
// raises on it); the kernel reads nothing for it and adds +0.0.
//
// Bound: bytes.  Each valid id reads one D-wide row, each bag writes one;
// nothing is reused, so the least time is (valid ids x D x 4 + ids + out)
// over the card's 3.35 TB/s.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // bags per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // row loads in flight per warp

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}

__global__ void __launch_bounds__(kThreads)
bag_kernel(const float* __restrict__ rows, const int64_t* __restrict__ ids,
           float* __restrict__ out, int bags, int k, int d, long long u) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= bags) return;
  const int64_t* bag_ids = ids + (size_t)bag * k;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int col = 4 * lane; col < d; col += 128) {
    float4 acc = zero;
    for (int base = 0; base < k; base += 32) {
      const int n = min(32, k - base);
      const long long mine = lane < n ? (long long)bag_ids[base + lane] : -1;
      for (int j = 0; j < n; j += kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          const long long id = __shfl_sync(0xffffffffu, mine, (j + t) & 31);
          v[t] = (j + t < n && id >= 0 && id < u)
                     ? *reinterpret_cast<const float4*>(rows + id * d + col)
                     : zero;
        }
#pragma unroll
        for (int t = 0; t < kUnroll; ++t)
          if (j + t < n) acc = add4(acc, v[t]);
      }
    }
    *reinterpret_cast<float4*>(out + (size_t)bag * d + col) = acc;
  }
}

}  // namespace

// rows [u, d] f32 (d % 128 == 0, 16-byte aligned), ids [bags, k] int64,
// out [bags, d] f32; all dense on the device.
extern "C" cudaError_t embedding_bag_f32(const float* rows,
                                         const int64_t* ids, float* out,
                                         int bags, int k, int d, long long u,
                                         cudaStream_t stream) {
  if (rows == nullptr || ids == nullptr || out == nullptr || bags <= 0 ||
      k <= 0 || d <= 0 || d % 128 || u <= 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((bags + kWarps - 1) / kWarps);
  bag_kernel<<<blocks, kThreads, 0, stream>>>(rows, ids, out, bags, k, d, u);
  return cudaGetLastError();
}
