// Fused Adam step over a whole group of parameters for Hopper (sm_90a),
// float32, with the optional bf16 copy of the new parameters.
//
// Replaces: paddle_tpu/pallas_kernels/fused_opt.py `_adam_kernel`
// (launched by `fused_adam_step`).  Per element of member i, with that
// member's lr_t = lr * sqrt(1 - beta2_pow_i) / (1 - beta1_pow_i) computed
// beforehand by the wrapper (one torch expression, as the plain version):
//
//   m1 = b1 * m1 + (1 - b1) * g
//   m2 = b2 * m2 + ((1 - b2) * g) * g
//   p  = p - lr_t * (m1 / (sqrt(m2) + eps))
//   bf = bfloat16(p)                       (only where a buffer is given)
//
// and each member's beta pows advance: beta1_pow *= b1, beta2_pow *= b2.
// Every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, ...), which the compiler never contracts into an FMA, so
// the result is bitwise the plain PyTorch version's, which runs each of
// them as its own op.  p, m1, m2 and the beta pows are updated in place
// (the op's ParamOut, Moment1Out, ... are its Param, Moment1, ... vars).
//
// Bound: bytes.  Each element reads p, g, m1, m2 and writes p, m1, m2
// (28 bytes, 30 with the bf16 copy) for ~12 flops.  Design: ONE launch
// for the group.  The TPU kernel pads every member to whole (8, 128)
// tiles of one flat buffer; here members stay where they are: a device
// table holds each member's pointers and size and the prefix of its
// block counts (built once per group by the wrapper and cached; only
// the gradients' pointers are new each step), a CTA finds its member by
// binary search over that prefix, and its 256 threads update 1024
// consecutive elements of it, each load and store coalesced.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kPerBlock = (long long)kThreads * kPerThread;

// table rows of n entries each: 0 p, 1 m1, 2 m2, 3 beta1_pow, 4 beta2_pow,
// 5 bf16 copy (0: none), 6 size; then n + 1 block-count prefixes
enum { kP, kM1, kM2, kB1Pow, kB2Pow, kBf16, kSize, kRows };

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const long long* __restrict__ table,
                  const long long* __restrict__ grads,
                  const float* __restrict__ lr_t, int n, float b1, float b2,
                  float omb1, float omb2, float eps) {
  const long long* starts = table + (size_t)kRows * n;
  const long long blk = blockIdx.x;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int m = lo;
  float* p = reinterpret_cast<float*>(table[kP * n + m]);
  float* m1 = reinterpret_cast<float*>(table[kM1 * n + m]);
  float* m2 = reinterpret_cast<float*>(table[kM2 * n + m]);
  __nv_bfloat16* bf = reinterpret_cast<__nv_bfloat16*>(table[kBf16 * n + m]);
  const float* g = reinterpret_cast<const float*>(grads[m]);
  const long long size = table[kSize * n + m];
  const float lr = lr_t[m];
  const long long off = (blk - starts[m]) * kPerBlock;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = off + threadIdx.x + (long long)j * kThreads;
    if (i >= size) break;
    const float gi = g[i];
    const float m1n = __fadd_rn(__fmul_rn(b1, m1[i]), __fmul_rn(omb1, gi));
    const float m2n =
        __fadd_rn(__fmul_rn(b2, m2[i]), __fmul_rn(__fmul_rn(omb2, gi), gi));
    const float u = __fdiv_rn(m1n, __fadd_rn(__fsqrt_rn(m2n), eps));
    const float pn = __fsub_rn(p[i], __fmul_rn(lr, u));
    p[i] = pn;
    m1[i] = m1n;
    m2[i] = m2n;
    if (bf != nullptr) bf[i] = __float2bfloat16_rn(pn);
  }
  if (blk == starts[m] && threadIdx.x == 0) {
    float* b1p = reinterpret_cast<float*>(table[kB1Pow * n + m]);
    float* b2p = reinterpret_cast<float*>(table[kB2Pow * n + m]);
    b1p[0] = __fmul_rn(b1p[0], b1);
    b2p[0] = __fmul_rn(b2p[0], b2);
  }
}

}  // namespace

// table: device int64 [kRows * n + n + 1] as above; grads: device int64
// [n] pointers; lr_t: device float [n]; total_blocks = table's last prefix
extern "C" cudaError_t fused_adam_f32(const long long* table,
                                      const long long* grads,
                                      const float* lr_t, int n,
                                      long long total_blocks, float b1,
                                      float b2, float omb1, float omb2,
                                      float eps, cudaStream_t stream) {
  if (table == nullptr || grads == nullptr || lr_t == nullptr || n <= 0 ||
      total_blocks < n || total_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  fused_adam_kernel<<<(unsigned)total_blocks, kThreads, 0, stream>>>(
      table, grads, lr_t, n, b1, b2, omb1, omb2, eps);
  return cudaGetLastError();
}
