// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/paged_attention.py `_paged_kernel`
// (launched by `_paged_pallas`).  Same function: one query token per lane
// attends over that lane's KV history, which lives in fixed-size blocks of
// a shared pool named by the lane's row of `block_tables`:
//
//   out[b, h] = softmax_s(q[b, h] . K[b, s, h] * scale) @ V[b, s, h]
//   over positions s < context_lens[b]; K/V position s of lane b lives at
//   block max(block_tables[b, s / bs], 0), offset s % bs.
//
// Bound: the kernel must read the live K and V rows once each,
// sum_b lens_b * H * D * 4 bytes twice, and does ~4 flops per byte read,
// far below the card's ~20 f32 flop/byte ridge, so it is memory-bound.
// Design against that bound:
//   * one thread block per (lane, head), 8 warps;
//   * each block copies its own table row into shared memory and walks only
//     the ceil(lens / bs) blocks that hold live positions: masked positions
//     contribute exactly 0 to the reference's softmax (exp(-1e30 - m) == 0
//     once any live score exists), so skipping them is exact up to the order
//     of summation, and no byte past a lane's length is read;
//   * a warp takes 4 positions at a time, each lane of the warp reading
//     consecutive floats of one K row and one V row (coalesced), so every
//     warp has 8 independent loads per lane in flight before it reduces;
//   * f32 online-softmax state (max, sum, accumulator) lives in registers
//     per warp, and the 8 warps are merged once through shared memory at
//     the end: no gathered [B, S, H, D] copy ever reaches device memory.
// Lanes with context_lens <= 0 are idle lanes of a decode bucket; they write
// zeros (the reference yields a uniform average there, and the engine
// discards both).  The TPU grid (b, j) with a sequential j axis is not
// carried over: the j loop runs inside the block.
//
// Entry point: plain C, returns the launch's cudaError_t.  Block ids are
// clamped to [0, num_blocks) so a bad table can never read outside the pool.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTok = 4;            // positions per warp per iteration
constexpr int kMaxD = 256;
constexpr int kMaxTable = 8192;    // table row kept in shared memory
constexpr float kMask = -1e30f;    // finite, as in the reference

template <int NI>  // NI = ceil(D / 32) floats per lane
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_cache,
                       const float* __restrict__ v_cache,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       float* __restrict__ out,
                       int H, int D, int NB, int BS, int MAXB, float scale) {
  extern __shared__ int s_table[];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][NI * 32];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* o = out + ((size_t)b * H + h) * D;

  int n = context_lens[b];
  if (n > MAXB * BS) n = MAXB * BS;
  if (n <= 0) {
    for (int d = tid; d < D; d += kThreads) o[d] = 0.f;
    return;
  }
  const int nblk = (n + BS - 1) / BS;
  for (int j = tid; j < nblk; j += kThreads) {
    int t = block_tables[(size_t)b * MAXB + j];
    t = t < 0 ? 0 : (t >= NB ? NB - 1 : t);
    s_table[j] = t;
  }
  __syncthreads();

  float qr[NI];
  const float* qp = q + ((size_t)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? qp[d] : 0.f;
  }

  const size_t row = (size_t)H * D;  // floats between positions of a block
  float m = kMask, l = 0.f;
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;

  for (int t0 = warp * kTok; t0 < n; t0 += kWarps * kTok) {
    float kr[kTok][NI], vr[kTok][NI];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int t = t0 + u;
      if (t < n) {
        const size_t base =
            ((size_t)s_table[t / BS] * BS + t % BS) * row + (size_t)h * D;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          kr[u][i] = d < D ? k_cache[base + d] : 0.f;
          vr[u][i] = d < D ? v_cache[base + d] : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NI; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float s[kTok];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) dot += qr[i] * kr[u][i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      // scale after the dot product, as the reference does
      s[u] = (t0 + u < n) ? dot * scale : -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kTok; ++u) mx = fmaxf(mx, s[u]);
    const float alpha = expf(m - mx);
    float p[kTok], psum = 0.f;
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      p[u] = expf(s[u] - mx);
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kTok; ++u) a += p[u] * vr[u][i];
      acc[i] = a;
    }
    m = mx;
  }

  // merge the warps: a warp that saw no position holds (kMask, 0, 0) and
  // weighs exp(kMask - M) == 0
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) s_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  float M = s_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, s_m[w]);
  float wsc[kWarps], L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wsc[w] = expf(s_m[w] - M);
    L += s_l[w] * wsc[w];
  }
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][d] * wsc[w];
    o[d] = a / L;
  }
}

template <int NI>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* tables, const int* lens, float* out, int B,
                   int H, int D, int NB, int BS, int MAXB, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  const size_t smem = (size_t)MAXB * sizeof(int);
  paged_attention_kernel<NI><<<grid, kThreads, smem, stream>>>(
      q, k, v, tables, lens, out, H, D, NB, BS, MAXB, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t paged_attention_f32(
    const float* q, const float* k_cache, const float* v_cache,
    const int* block_tables, const int* context_lens, float* out, int B,
    int H, int D, int NB, int BS, int MAXB, float scale,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || NB <= 0 || BS <= 0 ||
      MAXB <= 0 || MAXB > kMaxTable || B > 65535)
    return cudaErrorInvalidValue;
  switch ((D + 31) / 32) {
    case 1: return launch<1>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    case 2: return launch<2>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    case 3: return launch<3>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    case 4: return launch<4>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    case 5: return launch<5>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    case 6: return launch<6>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    case 7: return launch<7>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
    default: return launch<8>(q, k_cache, v_cache, block_tables, context_lens, out, B, H, D, NB, BS, MAXB, scale, stream);
  }
}
