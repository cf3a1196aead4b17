// Dropout with a byte-quantised keep draw for Hopper (sm_90a), float32 and
// bfloat16.
//
// Replaces no TPU kernel: the JAX package draws the dropout op's mask in
// jnp (paddle_tpu/ops/nn.py `dropout`, ops/common.py `bernoulli_bytes`).
// On the card the draw is this kernel, because the plain PyTorch Philox
// (int64 emulation, kernels/philox.py) would launch ~60 elementwise
// kernels per dropout op on a training step whose host already issues
// every op.  Same function as the plain version, bit for bit:
//
//   byte e = byte (e & 3) of u32 element (e >> 2) of the Philox stream
//            keyed by (k0, k1) (philox.cuh),
//   keep   = byte < thr  (thr = round(q 256), 0..256),
//   mask[e] = keep,  out[e] = keep ? (upscale ? x[e] / q : x[e]) : 0,
//
// with the division the reference's `x / q` (IEEE, not a multiply by 1/q).
// The bf16 instantiation (the AMP policy's attention probabilities) widens
// x to f32, divides and rounds once to bf16: q = round(keep 256) / 256 has
// at most 8 significant bits, so it is exact in bf16, and an f32 quotient
// of 8-bit operands rounded to bf16 is the correctly rounded bf16 quotient
// (24 >= 2 * 8 + 2), which is what the plain version and the reference
// compute.
//
// Bound: bytes.  It reads x (4 B an element, 2 in bf16) and writes out (4
// or 2 B) and the mask (1 B), ~1 flop a byte plus a tenth of a Philox call
// an element.  Design: one thread takes 16 consecutive elements, the 16
// bytes of one Philox call, with 16-byte loads and stores where the
// pointers allow (four float4, or two of eight bf16); a grid-stride loop
// covers any size.
//
// Entry points: plain C, return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// 16 consecutive elements of x as f32, and back, for each element type:
// four float4 or two uint4 of eight bf16
__device__ __forceinline__ void load16(const float* x, float* v) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = x4[j];
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = a.z;
    v[4 * j + 3] = a.w;
  }
}

__device__ __forceinline__ void store16(float* out, const float* v) {
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o4[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* x, float* v) {
  const uint4* x8 = reinterpret_cast<const uint4*>(x);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 a = x8[j];
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // a bf16 is the high half of the f32 with the same value
      v[8 * j + 2 * k] = __uint_as_float(w[k] << 16);
      v[8 * j + 2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* v) {
  uint4* o8 = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    o8[j] = make_uint4(pack_bf16x2(v[8 * j], v[8 * j + 1]),
                       pack_bf16x2(v[8 * j + 2], v[8 * j + 3]),
                       pack_bf16x2(v[8 * j + 4], v[8 * j + 5]),
                       pack_bf16x2(v[8 * j + 6], v[8 * j + 7]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
               uint8_t* __restrict__ mask, long long n, uint32_t k0,
               uint32_t k1, uint32_t thr, float q, int upscale, int vec) {
  const long long groups = (n + 15) / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < groups; t += stride) {
    const uint4 r = philox::group((unsigned long long)t, k0, k1);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    const long long e0 = 16 * t;
    float xv[16], ov[16];
    uint8_t mv[16];
    const bool full = vec && e0 + 16 <= n;
    if (full) {
      load16(x + e0, xv);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xv[j] = e0 + j < n ? to_f32(x[e0 + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t byte = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      const bool keep = byte < thr;
      mv[j] = keep ? 1 : 0;
      ov[j] = keep ? (upscale ? xv[j] / q : xv[j]) : 0.f;
    }
    if (full) {
      store16(out + e0, ov);
      uint4 m;
      m.x = mv[0] | mv[1] << 8 | mv[2] << 16 | (uint32_t)mv[3] << 24;
      m.y = mv[4] | mv[5] << 8 | mv[6] << 16 | (uint32_t)mv[7] << 24;
      m.z = mv[8] | mv[9] << 8 | mv[10] << 16 | (uint32_t)mv[11] << 24;
      m.w = mv[12] | mv[13] << 8 | mv[14] << 16 | (uint32_t)mv[15] << 24;
      *reinterpret_cast<uint4*>(mask + e0) = m;
    } else {
      for (int j = 0; j < 16 && e0 + j < n; ++j) {
        put(out + e0 + j, ov[j]);
        mask[e0 + j] = mv[j];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, T* out, uint8_t* mask, long long n,
                   unsigned int k0, unsigned int k1, unsigned int thr,
                   float q, int upscale, cudaStream_t stream) {
  if (x == nullptr || out == nullptr || mask == nullptr || n <= 0 ||
      thr > 256u || !(q > 0.f))
    return cudaErrorInvalidValue;
  // 16-byte accesses need every pointer 16-byte aligned
  const int vec = ((uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)mask % 16 == 0)
                      ? 1
                      : 0;
  const long long groups = (n + 15) / 16;
  const long long want = (groups + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  dropout_kernel<T><<<blocks, kThreads, 0, stream>>>(x, out, mask, n, k0, k1,
                                                     thr, q, upscale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t dropout_fwd_f32(const float* x, float* out,
                                       uint8_t* mask, long long n,
                                       unsigned int k0, unsigned int k1,
                                       unsigned int thr, float q, int upscale,
                                       cudaStream_t stream) {
  return launch(x, out, mask, n, k0, k1, thr, q, upscale, stream);
}

extern "C" cudaError_t dropout_fwd_bf16(const __nv_bfloat16* x,
                                        __nv_bfloat16* out, uint8_t* mask,
                                        long long n, unsigned int k0,
                                        unsigned int k1, unsigned int thr,
                                        float q, int upscale,
                                        cudaStream_t stream) {
  return launch(x, out, mask, n, k0, k1, thr, q, upscale, stream);
}
