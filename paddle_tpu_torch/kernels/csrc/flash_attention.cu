// Flash attention forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/flash_attention.py `_fwd_kernel`
// (launched by `_fwd_pallas`).  Same function:
//
//   s[b,h,i,j] = (q[b,h,i] . k[b,h,j]) * scale + bias[b, h|0, i, j]
//   s = -1e30 where causal and j > i      (finite, as in the reference)
//   out = softmax_j(s) @ v,  lse = logsumexp_j(s)        (lse in f32)
//
// A fully masked row (every s == -1e30) softmaxes to a uniform average,
// so its output is mean(V), never NaN, as in the reference.  Unlike the
// TPU kernel, which needs Sq and Sk to be multiples of its 128..1024
// blocks, any Sq and Sk are taken: tail rows are computed and not
// written, tail columns score -inf (weight exactly 0).  D <= 128.
//
// Bound: 4*B*H*Sq*Sk*D flops against (q+k+v+bias+out+lse) bytes; at
// BERT's S = 128, D = 64 that is ~32 flops per byte, above the card's
// ~20 f32 flop/byte ridge, so the work is operations-bound on the f32
// SIMT pipes (the tensor cores, through wgmma/TMA, are a later step).
// Design, a simple right one first:
//   * one 256-thread CTA per (b, h, 64-row q tile); the TPU's sequential
//     k-block grid axis becomes a loop over 64-column k tiles inside the
//     CTA, with the online softmax state (max, sum, accumulator) in f32
//     registers: the [Sq, Sk] score matrix never reaches device memory;
//   * the q tile is loaded once, each k/v tile once per CTA into shared
//     memory (rows padded by one float so the strided reads of the score
//     loop fall in distinct banks);
//   * thread (rg, cg) owns rows 4rg..4rg+3 and columns cg, cg+16, cg+32,
//     cg+48 of a score tile: 16 scores in registers, row max and sum
//     reduced over the 16 lanes of its half-warp with shuffles;
//   * probabilities go through shared memory into the p @ v product,
//     where the same thread owns 4 rows x ceil(D/16) output columns;
//   * causal: k tiles wholly above the tile's last row are skipped.
// q, k and v are read through (batch, head, row) strides with unit
// stride along D, so a transposed view needs no copy; bias, out and lse
// are contiguous.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr float kMask = -1e30f;

struct Strides {
  long long b, h, s;
};

template <int DC>  // DC = ceil(D / 16) output columns per thread
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Sq, int Sk, int D, int bias_heads, int causal,
                 float scale, Strides qs, Strides ks, Strides vs) {
  extern __shared__ float smem[];
  const int ld = D + 1;            // padded row stride of the q, k tiles
  float* sQ = smem;                // kBQ x ld
  float* sK = sQ + kBQ * ld;       // kBK x ld
  float* sV = sK + kBK * ld;       // kBK x D
  float* sP = sV + kBK * D;        // kBQ x (kBK + 1)
  constexpr int ldp = kBK + 1;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4rg .. 4rg+3 of the tile
  const int cg = tid & 15;  // columns cg + 16j

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* bb = nullptr;
  if (bias_heads > 0)
    bb = bias + ((size_t)b * bias_heads + (bias_heads > 1 ? h : 0)) *
                    (size_t)Sq * Sk;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    sQ[r * ld + d] = q0 + r < Sq ? qb[(q0 + r) * qs.s + d] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nkt = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(Sq, q0 + kBQ) - 1;
    nkt = min(nkt, last_row / kBK + 1);
  }
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    const int kvalid = min(kBK, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = r < kvalid;
      sK[r * ld + d] = in ? kb[(k0 + r) * ks.s + d] : 0.f;
      sV[r * D + d] = in ? vb[(k0 + r) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float x = s[i][j] * scale;  // scale after the dot, as the reference
        if (col >= Sk) {
          x = -INFINITY;            // tail column: weight exactly 0
        } else {
          if (bb != nullptr && row < Sq) x += bb[(size_t)row * Sk + col];
          if (causal && col > row) x = kMask;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        sP[(rg * 4 + i) * ldp + cg + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kvalid; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = cg + 16 * c;
        const float vv = d < D ? sV[kk * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

  const size_t head = (size_t)b * H + h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float L = l[i] == 0.f ? 1.f : l[i];
    float* o = out + (head * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = cg + 16 * c;
      if (d < D) o[d] = acc[i][c] / L;
    }
    if (cg == 0) lse[head * Sq + row] = m[i] + logf(L);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * (kBK + 1));
}

// The dynamic shared-memory limit of flash_fwd_kernel<DC> is raised once
// per device, to what its largest D (16 * DC) needs, so that a launch
// costs no attribute call.
template <int DC>
cudaError_t ensure_smem_limit() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(16 * DC));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* out, float* lse, int B, int H,
                   int Sq, int Sk, int D, int bias_heads, int causal,
                   float scale, Strides qs, Strides ks, Strides vs,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = ensure_smem_limit<DC>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DC><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, out, lse, H, Sq, Sk, D, bias_heads, causal, scale, qs,
      ks, vs);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, float* lse, int B, int H, int Sq, int Sk, int D,
    int bias_heads, int causal, float scale, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > kMaxD ||
      B > 65535 || H > 65535 || (bias_heads != 0 && bias_heads != 1 &&
                                 bias_heads != H) ||
      (bias_heads != 0 && bias == nullptr))
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  switch ((D + 15) / 16) {
    case 1: return launch<1>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    case 2: return launch<2>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    case 3: return launch<3>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    case 4: return launch<4>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    case 5: return launch<5>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    case 6: return launch<6>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    case 7: return launch<7>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
    default: return launch<8>(q, k, v, bias, out, lse, B, H, Sq, Sk, D, bias_heads, causal, scale, qs, ks, vs, stream);
  }
}
