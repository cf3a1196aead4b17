// Fused momentum step over a whole group of parameters for Hopper
// (sm_90a), float32, with the optional bf16 copy of the new parameters.
//
// Replaces: paddle_tpu/pallas_kernels/fused_opt.py `_momentum_kernel`
// (launched by `fused_momentum_step`).  Per element, with the group's one
// learning rate lr (read on the card from the op's LearningRate) and mu:
//
//   v = mu * v + g
//   p = p - lr * v                    (plain)
//   p = p - (g + mu * v) * lr         (Nesterov)
//   bf = bfloat16(p)                  (only where a buffer is given)
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, ...), which the compiler never contracts into an FMA, so the
// result is bitwise the plain PyTorch version's, which runs each of them as
// its own op.  p and v are updated in place (the op's ParamOut and
// VelocityOut are its Param and Velocity vars).
//
// Bound: bytes.  Each element reads p, g, v and writes p, v (20 bytes, 22
// with the bf16 copy) for 3-5 flops.  Design as csrc/fused_adam.cu: ONE
// launch for the group; a device table holds each member's pointers and
// size and the prefix of its block counts (built once per group by the
// wrapper and cached; only the gradients' pointers are new each step); a
// CTA finds its member by binary search over that prefix, and its 256
// threads update 1024 consecutive elements of it, each load and store
// coalesced.  The TPU kernel's padding of every member to whole (8, 128)
// tiles of one flat buffer has no counterpart: members stay where they are.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kPerBlock = (long long)kThreads * kPerThread;

// table rows of n entries each: 0 p, 1 v, 2 bf16 copy (0: none), 3 size;
// then n + 1 block-count prefixes
enum { kP, kV, kBf16, kSize, kRows };

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
fused_momentum_kernel(const long long* __restrict__ table,
                      const long long* __restrict__ grads,
                      const float* __restrict__ lr_p, int n, float mu) {
  const long long* starts = table + (size_t)kRows * n;
  const long long blk = blockIdx.x;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int m = lo;
  float* p = reinterpret_cast<float*>(table[kP * n + m]);
  float* v = reinterpret_cast<float*>(table[kV * n + m]);
  __nv_bfloat16* bf = reinterpret_cast<__nv_bfloat16*>(table[kBf16 * n + m]);
  const float* g = reinterpret_cast<const float*>(grads[m]);
  const long long size = table[kSize * n + m];
  const float lr = lr_p[0];
  const long long off = (blk - starts[m]) * kPerBlock;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = off + threadIdx.x + (long long)j * kThreads;
    if (i >= size) break;
    const float gi = g[i];
    const float vn = __fadd_rn(__fmul_rn(mu, v[i]), gi);
    const float pn =
        kNesterov ? __fsub_rn(p[i], __fmul_rn(__fadd_rn(gi, __fmul_rn(mu, vn)),
                                              lr))
                  : __fsub_rn(p[i], __fmul_rn(lr, vn));
    p[i] = pn;
    v[i] = vn;
    if (bf != nullptr) bf[i] = __float2bfloat16_rn(pn);
  }
}

}  // namespace

// table: device int64 [kRows * n + n + 1] as above; grads: device int64
// [n] pointers; lr: device float [1]; total_blocks = table's last prefix
extern "C" cudaError_t fused_momentum_f32(const long long* table,
                                          const long long* grads,
                                          const float* lr, int n,
                                          long long total_blocks, float mu,
                                          int nesterov, cudaStream_t stream) {
  if (table == nullptr || grads == nullptr || lr == nullptr || n <= 0 ||
      total_blocks < n || total_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (nesterov)
    fused_momentum_kernel<true><<<(unsigned)total_blocks, kThreads, 0,
                                  stream>>>(table, grads, lr, n, mu);
  else
    fused_momentum_kernel<false><<<(unsigned)total_blocks, kThreads, 0,
                                   stream>>>(table, grads, lr, n, mu);
  return cudaGetLastError();
}
