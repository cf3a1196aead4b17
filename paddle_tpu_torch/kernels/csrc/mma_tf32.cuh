// Device helpers shared by the port's tensor-core and cp.async kernels
// (conv_block.cu, flash_attention.cu, flash_bwd.cuh):
//
//   * cp.async copies of 16 or 4 bytes into shared memory, which zero-fill
//     their destination where the copy is masked off, and their commit and
//     wait;
//   * 3xTF32 on `mma.sync.m16n8k8`: `split_tf32` splits an f32 operand
//     into a TF32 part and a TF32 remainder, `mma_tf32` adds one m16n8k8
//     product into f32 accumulators.  A kernel multiplies small * big +
//     big * small + big * big, which keeps f32 accuracy where one TF32
//     product misses it, and sums each 32-deep slice of a product from
//     zero before adding it into f32 registers: the tensor core cuts the
//     sums it accumulates (tests/test_torch_conv_tf32.py).

#pragma once

#include <cuda_runtime.h>

namespace {

// ok false: src-size 0, the 16 (4) destination bytes are zero-filled and
// src is not read
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the N most recently committed has landed (this
// thread's copies; a barrier makes them every thread's)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every copy this thread issued has landed, committed or not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v ~ big + small: big = v rounded to TF32, to nearest with ties away
// from zero (half a TF32 ulp added to the magnitude bits, the low 13 cut:
// the bits of cvt.rna.tf32.f32, in two integer operations at full rate);
// small = v - big, exact, of which the tensor core reads the top 10
// mantissa bits (2^-21 of v)
__device__ __forceinline__ void split_tf32(float v, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d += a * b over one m16n8k8 fragment
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
