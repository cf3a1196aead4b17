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
// with the bf16 copy) for 3-5 flops.  Design:
// * The group's descriptor rides in the launch itself, by value, as a
//   __grid_constant__ parameter block (Group, ~5.6 KB; CUDA 12.1 takes up
//   to 32,764 bytes of parameters): each member's p, v, bf16 and this
//   step's grad pointers, its size and the prefix of its block counts.  No
//   table is copied to the card per step, and a CTA finds its member by a
//   binary search in the constant bank, every thread of the CTA reading the
//   same address, with no global load before its data.  A group of more
//   than kCap members is split by the wrapper into launches of whole
//   members (the planner in fused_momentum.py).
// * A CTA takes kPerBlock consecutive elements of one member; each thread
//   loads kVecs float4 of g, p and v (192 bytes) into registers before its
//   first store, then writes p, v and 8 bytes of bf16 copy a float4.
//   Loads and stores of a warp cover 512 contiguous bytes.
// * Alignment: members keep their own storage (the TPU kernel's padding of
//   every member to whole (8, 128) tiles of one flat buffer has no
//   counterpart).  A CTA whose p, v and g share their 16-byte phase (and
//   the bf16 copy the matching 8-byte phase) runs a scalar head up to the
//   first 16-byte boundary, the float4 body and a scalar tail; one whose
//   pointers disagree runs its elements one by one.  The choice is made
//   per CTA from the pointer bits, a uniform branch.
//
// Entry points: plain C; the launch returns its cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 2048 elements a CTA: 128 threads of 4 float4 each timed 1-2% faster
// than 256 of 2 or 512 of 1, 4096 elements a CTA 1% slower, 1024 3% slower
constexpr int kThreads = 128;
constexpr int kVecs = 4;  // float4 of each tensor a thread keeps in flight
constexpr int kPerBlock = kThreads * 4 * kVecs;
constexpr int kCap = 128;  // members a launch's parameter block holds

struct Group {
  const float* g[kCap];
  float* p[kCap];
  float* v[kCap];
  __nv_bfloat16* bf[kCap];  // nullptr: no copy
  long long size[kCap];
  int start[kCap + 1];  // block-count prefix, start[0] = 0
  int n;
  const float* lr;
  float mu;
};

template <bool kNesterov>
__device__ __forceinline__ void momentum(float& p, float& v, float g,
                                         float lr, float mu) {
  v = __fadd_rn(__fmul_rn(mu, v), g);
  p = kNesterov ? __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(mu, v)), lr))
                : __fsub_rn(p, __fmul_rn(lr, v));
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <bool kNesterov>
__device__ __forceinline__ void one(float* __restrict__ p,
                                    float* __restrict__ v,
                                    const float* __restrict__ g,
                                    __nv_bfloat16* __restrict__ bf, int i,
                                    float lr, float mu) {
  float pi = p[i], vi = v[i];
  momentum<kNesterov>(pi, vi, __ldg(g + i), lr, mu);
  p[i] = pi;
  v[i] = vi;
  if (bf != nullptr) bf[i] = __float2bfloat16_rn(pi);
}

// elements threadIdx.x + j * kThreads, j < kPer, below len, one by one
// (all loads before the first store)
template <bool kNesterov, int kPer>
__device__ __forceinline__ void scalar_run(
    float* __restrict__ p, float* __restrict__ v, const float* __restrict__ g,
    __nv_bfloat16* __restrict__ bf, int len, float lr, float mu) {
  float ps[kPer], vs[kPer], gs[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < len) {
      gs[j] = __ldg(g + i);
      ps[j] = p[i];
      vs[j] = v[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < len) {
      momentum<kNesterov>(ps[j], vs[j], gs[j], lr, mu);
      p[i] = ps[j];
      v[i] = vs[j];
      if (bf != nullptr) bf[i] = __float2bfloat16_rn(ps[j]);
    }
  }
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
fused_momentum_kernel(const __grid_constant__ Group grp) {
  const float lr = __ldg(grp.lr);
  const float mu = grp.mu;
  const int blk = blockIdx.x;
  int lo = 0, hi = grp.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (grp.start[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const long long off = (long long)(blk - grp.start[lo]) * kPerBlock;
  const long long rem = grp.size[lo] - off;
  const int len = rem < kPerBlock ? (int)(rem > 0 ? rem : 0) : kPerBlock;
  float* __restrict__ p = grp.p[lo] + off;
  float* __restrict__ v = grp.v[lo] + off;
  const float* __restrict__ g = grp.g[lo] + off;
  __nv_bfloat16* __restrict__ bf =
      grp.bf[lo] != nullptr ? grp.bf[lo] + off : nullptr;

  // off is a multiple of 4 elements, so every CTA of a member has the
  // member's phase
  const unsigned long long pa = (unsigned long long)p;
  const unsigned ph = (unsigned)(pa >> 2) & 3u;
  const bool vec =
      (pa & 3ull) == 0 && ((pa ^ (unsigned long long)v) & 15ull) == 0 &&
      ((pa ^ (unsigned long long)g) & 15ull) == 0 &&
      (bf == nullptr || (((unsigned long long)bf >> 1) & 3ull) == ph);
  if (!vec) {
    scalar_run<kNesterov, kPerBlock / kThreads>(p, v, g, bf, len, lr, mu);
    return;
  }
  const int head = min((int)((4u - ph) & 3u), len);
  const int nv = (len - head) >> 2;
  const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + head);
  float4* __restrict__ p4 = reinterpret_cast<float4*>(p + head);
  float4* __restrict__ v4 = reinterpret_cast<float4*>(v + head);
  uint2* __restrict__ b4 =
      bf != nullptr ? reinterpret_cast<uint2*>(bf + head) : nullptr;
  float4 gr[kVecs], pr[kVecs], vr[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < nv) {
      // a coherent load: ptxas sinks a non-coherent (__ldg) one of the
      // four below the first stores
      gr[j] = __ldcg(g4 + k);
      pr[j] = p4[k];
      vr[j] = v4[k];
    }
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < nv) {
      momentum<kNesterov>(pr[j].x, vr[j].x, gr[j].x, lr, mu);
      momentum<kNesterov>(pr[j].y, vr[j].y, gr[j].y, lr, mu);
      momentum<kNesterov>(pr[j].z, vr[j].z, gr[j].z, lr, mu);
      momentum<kNesterov>(pr[j].w, vr[j].w, gr[j].w, lr, mu);
      p4[k] = pr[j];
      v4[k] = vr[j];
      if (b4 != nullptr)
        b4[k] = make_uint2(bf16x2(pr[j].x, pr[j].y),
                           bf16x2(pr[j].z, pr[j].w));
    }
  }
  // the scalar head [0, head) and tail [head + 4 nv, len), under 4 each:
  // one element each for the CTA's first threads
  const int tail = head + 4 * nv;
  const int t = threadIdx.x;
  if (t < head + len - tail)
    one<kNesterov>(p, v, g, bf, t < head ? t : tail + t - head, lr, mu);
}

}  // namespace

// The layout the wrapper's planner must follow: elements a CTA, members a
// launch.
extern "C" int fused_momentum_per_block() { return kPerBlock; }
extern "C" int fused_momentum_capacity() { return kCap; }

// One launch over n <= kCap whole members.  ptrs: host int64 [n][4], each
// member's p, v, bf16 copy (0: none) and grad (0 only in an empty
// member); sizes: host int64 [n]; starts: host int32 [n + 1], the
// block-count prefix of max(1, ceil(size / per_block)); lr: device float
// [1]; per_block must be kPerBlock.  The host arrays are read before this
// returns (the launch copies the parameter block).
extern "C" cudaError_t fused_momentum_f32(const long long* ptrs,
                                          const long long* sizes,
                                          const int* starts, int n,
                                          const float* lr, float mu,
                                          int nesterov, int per_block,
                                          cudaStream_t stream) {
  if (ptrs == nullptr || sizes == nullptr || starts == nullptr ||
      lr == nullptr || n <= 0 || n > kCap || per_block != kPerBlock ||
      starts[0] != 0)
    return cudaErrorInvalidValue;
  Group grp{};
  for (int m = 0; m < n; ++m) {
    const long long* q = ptrs + 4 * m;
    const long long s = sizes[m];
    const long long blocks = s > kPerBlock ? (s + kPerBlock - 1) / kPerBlock
                                           : 1;
    if (s < 0 || (s > 0 && (q[0] == 0 || q[1] == 0 || q[3] == 0)) ||
        (long long)starts[m + 1] - starts[m] != blocks)
      return cudaErrorInvalidValue;
    grp.p[m] = reinterpret_cast<float*>(q[0]);
    grp.v[m] = reinterpret_cast<float*>(q[1]);
    grp.bf[m] = reinterpret_cast<__nv_bfloat16*>(q[2]);
    grp.g[m] = reinterpret_cast<const float*>(q[3]);
    grp.size[m] = s;
    grp.start[m + 1] = starts[m + 1];
  }
  grp.n = n;
  grp.lr = lr;
  grp.mu = mu;
  const unsigned blocks = (unsigned)starts[n];
  if (nesterov)
    fused_momentum_kernel<true><<<blocks, kThreads, 0, stream>>>(grp);
  else
    fused_momentum_kernel<false><<<blocks, kThreads, 0, stream>>>(grp);
  return cudaGetLastError();
}
