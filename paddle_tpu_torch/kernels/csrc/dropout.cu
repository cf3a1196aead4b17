// Dropout with a byte-quantised keep draw for Hopper (sm_90a), float32.
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
//
// Bound: bytes.  It reads x (4 B an element) and writes out (4 B) and the
// mask (1 B), ~1 flop a byte plus a tenth of a Philox call an element.
// Design: one thread takes 16 consecutive elements, the 16 bytes of one
// Philox call, with 16-byte loads and stores where the pointers allow;
// a grid-stride loop covers any size.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dropout_kernel(const float* __restrict__ x, float* __restrict__ out,
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
      const float4* x4 = reinterpret_cast<const float4*>(x + e0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 a = x4[j];
        xv[4 * j] = a.x;
        xv[4 * j + 1] = a.y;
        xv[4 * j + 2] = a.z;
        xv[4 * j + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) xv[j] = e0 + j < n ? x[e0 + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t byte = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      const bool keep = byte < thr;
      mv[j] = keep ? 1 : 0;
      ov[j] = keep ? (upscale ? xv[j] / q : xv[j]) : 0.f;
    }
    if (full) {
      float4* o4 = reinterpret_cast<float4*>(out + e0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o4[j] = make_float4(ov[4 * j], ov[4 * j + 1], ov[4 * j + 2],
                            ov[4 * j + 3]);
      uint4 m;
      m.x = mv[0] | mv[1] << 8 | mv[2] << 16 | (uint32_t)mv[3] << 24;
      m.y = mv[4] | mv[5] << 8 | mv[6] << 16 | (uint32_t)mv[7] << 24;
      m.z = mv[8] | mv[9] << 8 | mv[10] << 16 | (uint32_t)mv[11] << 24;
      m.w = mv[12] | mv[13] << 8 | mv[14] << 16 | (uint32_t)mv[15] << 24;
      *reinterpret_cast<uint4*>(mask + e0) = m;
    } else {
      for (int j = 0; j < 16 && e0 + j < n; ++j) {
        out[e0 + j] = ov[j];
        mask[e0 + j] = mv[j];
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t dropout_fwd_f32(const float* x, float* out,
                                       uint8_t* mask, long long n,
                                       unsigned int k0, unsigned int k1,
                                       unsigned int thr, float q, int upscale,
                                       cudaStream_t stream) {
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
  dropout_kernel<<<blocks, kThreads, 0, stream>>>(x, out, mask, n, k0, k1, thr,
                                                  q, upscale, vec);
  return cudaGetLastError();
}
