// Philox4x32-10, the port's dropout stream, for the kernels.
//
// The same function as paddle_tpu_torch/kernels/philox.py (which states
// the contract): element e of a tensor, its row-major global index, takes
// output lane e & 3 of Philox4x32-10 at counter (e >> 2) (low word, high
// word, 0, 0) under the key (seed[0], seed[1]).  The stream depends on the
// element index alone, so a backward kernel replays its forward's mask
// whatever its tiling.  It takes the place of the TPU's on-core generator
// (pltpu.prng_seed / prng_random_bits, paddle_tpu/pallas_kernels/prng.py).
//
// Keep draws:
//   fused kernels:  keep iff u32 < thr,  thr = round((1 - p) 2^32) >= 1,
//                   kept values times inv_q = 1 / (thr / 2^32) in f32;
//   dropout op:     byte e of the stream read little-endian < round(q 256).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// the four u32 of counter ctr: elements 4 ctr .. 4 ctr + 3 of the stream
__device__ __forceinline__ uint4 group(unsigned long long ctr, uint32_t k0,
                                       uint32_t k1) {
  return philox4x32_10((uint32_t)ctr, (uint32_t)(ctr >> 32), k0, k1);
}

__device__ __forceinline__ uint32_t lane(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// u32 of element e
__device__ __forceinline__ uint32_t u32_at(unsigned long long e, uint32_t k0,
                                           uint32_t k1) {
  return lane(group(e >> 2, k0, k1), (int)(e & 3));
}

}  // namespace philox
