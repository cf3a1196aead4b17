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
// At decode sizes the bytes take a few microseconds, so what sets the
// time is the chain of dependent loads one CTA walks.  Design:
//   * the grid is (H, B, S): each lane's context is cut into S splits of
//     `chunk` positions (the host derives both from the table width
//     MAXB * bs and the SM count, never from context_lens, which it would
//     have to wait for).  A CTA walks its own chunk only, so the longest
//     chain is chunk positions, not the lane's whole context;
//   * a CTA whose chunk starts at or past its lane's length exits: its
//     state would be (m = -1e30, l = 0, acc = 0), which weighs
//     exp(-1e30 - M) == 0 in the combine, so it is neither written nor
//     read;
//   * a lane whose context fits one chunk is finished by its one CTA,
//     which writes out directly: no partial, no combine (decode at short
//     contexts, and every table no wider than a chunk);
//   * otherwise each live CTA writes its (m, l, acc[D]) to a scratch
//     buffer, fences, and counts itself in on a per-(lane, head) counter;
//     the CTA that arrives last merges the partials in split order (so
//     the result is the same bits on every run, whichever CTA merges) and
//     sets the counter back to 0 for the next launch;
//   * inside a CTA, 16-byte loads: a group of LP lanes reads one K row and
//     one V row (LP = 16 float4s at D = 64: a warp takes two positions at
//     a time, each group's 256 bytes one coalesced segment), and each
//     group holds SLOTS positions' rows in registers before it reduces,
//     so a lane has 8 loads of 16 bytes in flight; the dot product is
//     reduced over the group's lanes by an xor butterfly;
//   * the chunk's table entries and q are loaded beside context_lens, not
//     after it, so a CTA waits for one load before its first K/V load;
//   * f32 online-softmax state (max, sum, accumulator) per group in
//     registers; a warp's groups are merged by an xor butterfly, the CTA's
//     8 warps once through shared memory (merging 16 group states there
//     cost 0.0003 ms at one block of 16 positions on an H100, PERF.md);
//     the last CTA's merge weighs each split once, not once a column.
//   Head widths that are not a multiple of 4 or under 16 (or unaligned
//   pools) take the same code with scalar loads, a warp a position.
// Lanes with context_lens <= 0 are idle lanes of a decode bucket; they write
// zeros (the reference yields a uniform average there, and the engine
// discards both).  The TPU grid (b, j) with a sequential j axis is not
// carried over: the j loop runs inside the CTA over its chunk.
//
// Entry point: plain C, returns the launch's cudaError_t.  Block ids are
// clamped to [0, num_blocks) so a bad table can never read outside the pool.
//
// paged_attention_int8, the same attention over int8 pools.
//
// Replaces: no Pallas kernel.  The int8 branch of make_paged_step
// (paddle_tpu/serving/decode_model.py:227-242) gathers the lane's whole
// table of int8 blocks and their f32 scales, dequantizes them and calls the
// jnp masked_attention:
//
//   out[b, h] = softmax_s(q . (Kq[s] ks[s]) * scale) @ (Vq[s] vs[s])
//
// with Kq, Vq int8 [NB, bs, H, D] and ks, vs f32 [NB, bs, H], one scale a
// (block, position, head).  On the card that gather would write
// [B, MAXB * bs, H, D] f32 a layer a step, four times the pools' bytes.
// Bound: bytes, as row 1, but a (position, head) costs D bytes of K and of
// V and 4 of each scale: 136 bytes at D = 64 against row 1's 512.
// Design: row 1's grid, chunks and merge (the code after the loop is the
// one `cta_finish`), its loop reading int8 rows in place:
//   * where D % 16 == 0 and the pools are 16-byte aligned, a lane reads 16
//     int8 values of a row with one 16-byte load, LP lanes a row; SLOTS
//     is chosen so that a CTA's 8 warps take 128 positions a step, one
//     chunk.  Otherwise (D = 30, 40: rows not 16-byte aligned) a warp
//     reads a position's row a byte a lane;
//   * each lane of a position's group loads the position's two scales
//     (one address for the group);
//   * the dot product sums q times the int8 values converted to f32, and
//     the position's K scale multiplies the sum once: (q . Kq[s]) ks[s];
//     the V scale multiplies the position's probability, p vs[s], before
//     it weighs the int8 row.  That reassociates the reference's
//     dequantize-then-dot, so the kernel agrees with it to rounding, not
//     bitwise; the merge order is row 1's, so two runs give the same bits.
// No dp4a and no tensor cores: the products are f32 FMAs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxTable = 8192;
constexpr int kMaxSplits = 1024;   // splits a lane
constexpr float kMask = -1e30f;    // finite, as in the reference

__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
}
__device__ __forceinline__ void fma_to(float& acc, float p, float v) {
  acc += p * v;
}
__device__ __forceinline__ void fma_to(float4& acc, float p,
                                       const float4& v) {
  acc.x += p * v.x;
  acc.y += p * v.y;
  acc.z += p * v.z;
  acc.w += p * v.w;
}
__device__ __forceinline__ void scale_by(float& acc, float a) { acc *= a; }
__device__ __forceinline__ void scale_by(float4& acc, float a) {
  acc.x *= a;
  acc.y *= a;
  acc.z *= a;
  acc.w *= a;
}
__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float4 shfl_xor(const float4& v, int off) {
  return make_float4(shfl_xor(v.x, off), shfl_xor(v.y, off),
                     shfl_xor(v.z, off), shfl_xor(v.w, off));
}
template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The end of both kernels' CTA: the 8 warps' states (s_m, s_l and kRow
// accumulator floats each in sa) weighed into the CTA's (M, L, acc); a
// lane whose context fits one chunk writes its output, otherwise the CTA
// writes its split's partial and the CTA of the lane that arrives last
// merges the live splits in split order and sets the counter back to 0.
template <int kRow>
__device__ __forceinline__ void cta_finish(
    const float* s_m, const float* s_l, const float* sa, float* s_pm,
    float* s_pl, int* s_last, float* o, float* part, int* count, size_t bh,
    int S, int split, int n_live, int D, int tid) {
  float M = s_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, s_m[w]);
  float wsc[kWarps], L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wsc[w] = expf(s_m[w] - M);
    L += s_l[w] * wsc[w];
  }
  if (n_live == 1) {                  // the lane's only chunk
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sa[w * kRow + d] * wsc[w];
      o[d] = a / L;
    }
    return;
  }

  // a partial of the lane's S: (m, l) then acc[D]
  float* pp = part + (bh * S + split) * (size_t)(D + 2);
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sa[w * kRow + d] * wsc[w];
    pp[2 + d] = a;
  }
  if (tid == 0) {
    pp[0] = M;
    pp[1] = L;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(&count[bh], 1) == n_live - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // the last CTA of the lane's live chunks merges them in split order
  const float* pb = part + bh * S * (size_t)(D + 2);
  for (int j = tid; j < n_live; j += kThreads) {
    s_pm[j] = __ldcg(pb + (size_t)j * (D + 2));
    s_pl[j] = __ldcg(pb + (size_t)j * (D + 2) + 1);
  }
  __syncthreads();
  float Mg = kMask;
  for (int j = 0; j < n_live; ++j) Mg = fmaxf(Mg, s_pm[j]);
  __syncthreads();
  for (int j = tid; j < n_live; j += kThreads)
    s_pm[j] = expf(s_pm[j] - Mg);     // split j's weight
  __syncthreads();
  float Lg = 0.f;
  for (int j = 0; j < n_live; ++j) Lg += s_pl[j] * s_pm[j];
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_live; ++j)
      a += __ldcg(pb + (size_t)j * (D + 2) + 2 + d) * s_pm[j];
    o[d] = a / Lg;
  }
  if (tid == 0) count[bh] = 0;        // ready for the next launch
}

// V: float4 or float; W = the floats in a V.  LP lanes read one position's
// row, VPL V's a lane (Dv = D / W <= LP * VPL); SLOTS positions a group
// holds before it reduces.  part / count are used only when the grid has
// more than one split.
template <typename V, int LP, int VPL, int SLOTS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const V* __restrict__ q, const V* __restrict__ k_cache,
                       const V* __restrict__ v_cache,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       float* __restrict__ out, float* __restrict__ part,
                       int* __restrict__ count, int H, int D, int NB, int BS,
                       int MAXB, int chunk, float scale) {
  constexpr int W = sizeof(V) / sizeof(float);
  constexpr int G = 32 / LP;          // groups (positions at once) a warp
  constexpr int PW = G * SLOTS;       // positions a warp per step
  extern __shared__ int s_table[];    // the chunk's block ids
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ V s_acc[kWarps][LP * VPL];
  __shared__ float s_pm[kMaxSplits];  // the merge: each split's m, l
  __shared__ float s_pl[kMaxSplits];
  __shared__ int s_last;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / LP;
  const int gl = lane % LP;
  const int Dv = D / W;
  const size_t bh = (size_t)b * H + h;
  float* o = out + bh * D;

  // the chunk's table entries and q do not depend on the lane's length:
  // their loads go out beside context_lens', not after it
  const int start = split * chunk;
  const int blk0 = start / BS;
  const int nblk = min(MAXB, (start + chunk - 1) / BS + 1) - blk0;
  for (int j = tid; j < nblk; j += kThreads) {
    int t = block_tables[(size_t)b * MAXB + blk0 + j];
    t = t < 0 ? 0 : (t >= NB ? NB - 1 : t);
    s_table[j] = t;
  }
  V qr[VPL];
  const V* qp = q + bh * Dv;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int d = gl + LP * i;
    qr[i] = d < Dv ? qp[d] : zero<V>();
  }
  int n = context_lens[b];
  if (n > MAXB * BS) n = MAXB * BS;
  if (n <= 0) {
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = 0.f;
    return;
  }
  if (start >= n) return;             // an empty chunk: weighs nothing
  const int end = min(n, start + chunk);
  const int n_live = (n + chunk - 1) / chunk;
  __syncthreads();

  const size_t row = (size_t)H * Dv;  // V's between positions of a block
  float m = kMask, l = 0.f;
  V acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = zero<V>();

  for (int t0 = start + warp * PW; t0 < end; t0 += kWarps * PW) {
    V kr[SLOTS][VPL], vr[SLOTS][VPL];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int t = t0 + u * G + grp;
      if (t < end) {
        const size_t base =
            ((size_t)s_table[t / BS - blk0] * BS + t % BS) * row +
            (size_t)h * Dv;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int d = gl + LP * i;
          kr[u][i] = d < Dv ? k_cache[base + d] : zero<V>();
          vr[u][i] = d < Dv ? v_cache[base + d] : zero<V>();
        }
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) kr[u][i] = vr[u][i] = zero<V>();
      }
    }
    float s[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      float dt = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) dt += dot(qr[i], kr[u][i]);
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1)
        dt += __shfl_xor_sync(0xffffffffu, dt, off);
      // scale after the dot product, as the reference does
      s[u] = (t0 + u * G + grp < end) ? dt * scale : -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) mx = fmaxf(mx, s[u]);
    const float alpha = expf(m - mx);
    float p[SLOTS], psum = 0.f;
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      p[u] = expf(s[u] - mx);
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      scale_by(acc[i], alpha);
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) fma_to(acc[i], p[u], vr[u][i]);
    }
    m = mx;
  }

  // merge the warp's groups by an xor butterfly over the lane bits above
  // LP (a group that saw no position holds (kMask, 0, 0) and weighs
  // exp(kMask - M) == 0), then the CTA's warps through shared memory
#pragma unroll
  for (int off = LP; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, mo);
    const float a = expf(m - mx), c = expf(mo - mx);
    l = l * a + lo * c;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const V other = shfl_xor(acc[i], off);  // before this lane rescales
      scale_by(acc[i], a);
      fma_to(acc[i], c, other);
    }
    m = mx;
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) s_acc[warp][gl + LP * i] = acc[i];
  }
  __syncthreads();
  cta_finish<LP * VPL * W>(s_m, s_l, reinterpret_cast<const float*>(
                               &s_acc[0][0]), s_pm, s_pl, &s_last, o, part,
                           count, bh, S, split, n_live, D, tid);
}

template <typename V, int LP, int VPL, int SLOTS>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* tables, const int* lens, float* out,
                   float* part, int* count, int B, int H, int D, int NB,
                   int BS, int MAXB, int chunk, int splits, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, B, splits);
  // the block ids of one chunk: it may start and end inside a block
  const size_t smem = (size_t)(chunk / BS + 2) * sizeof(int);
  paged_attention_kernel<V, LP, VPL, SLOTS><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const V*>(q), reinterpret_cast<const V*>(k),
      reinterpret_cast<const V*>(v), tables, lens, out, part, count, H, D,
      NB, BS, MAXB, chunk, scale);
  return cudaGetLastError();
}

// -- int8 residency ----------------------------------------------------------

// W int8 values a lane reads at once: 16 (one 16-byte load) or 1
template <int W>
struct I8;
template <>
struct I8<16> {
  using T = int4;
};
template <>
struct I8<1> {
  using T = signed char;
};

__device__ __forceinline__ void to_f32(const int4& r, float (&f)[16]) {
  const int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * j + b] =
          static_cast<float>(static_cast<signed char>((w[j] >> (8 * b)) & 0xff));
}
__device__ __forceinline__ void to_f32(signed char r, float (&f)[1]) {
  f[0] = static_cast<float>(r);
}

// LP lanes read one position's row, VPL chunks of W int8 values a lane
// (Dv = D / W <= LP * VPL); SLOTS positions a group holds before it
// reduces.  The grid, the chunk's table, the idle and empty CTAs and the
// end are row 1's.
template <int W, int LP, int VPL, int SLOTS>
__global__ void __launch_bounds__(kThreads)
paged_attention_int8_kernel(const float* __restrict__ q,
                            const typename I8<W>::T* __restrict__ k_cache,
                            const typename I8<W>::T* __restrict__ v_cache,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ context_lens,
                            float* __restrict__ out, float* __restrict__ part,
                            int* __restrict__ count, int H, int D, int NB,
                            int BS, int MAXB, int chunk, float scale) {
  using T = typename I8<W>::T;
  constexpr int G = 32 / LP;          // groups (positions at once) a warp
  constexpr int PW = G * SLOTS;       // positions a warp per step
  constexpr int kRow = LP * VPL * W;  // floats of one warp's accumulator
  extern __shared__ int s_table[];    // the chunk's block ids
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][kRow];
  __shared__ float s_pm[kMaxSplits];  // the merge: each split's m, l
  __shared__ float s_pl[kMaxSplits];
  __shared__ int s_last;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / LP;
  const int gl = lane % LP;
  const int Dv = D / W;
  const size_t bh = (size_t)b * H + h;
  float* o = out + bh * D;

  const int start = split * chunk;
  const int blk0 = start / BS;
  const int nblk = min(MAXB, (start + chunk - 1) / BS + 1) - blk0;
  for (int j = tid; j < nblk; j += kThreads) {
    int t = block_tables[(size_t)b * MAXB + blk0 + j];
    t = t < 0 ? 0 : (t >= NB ? NB - 1 : t);
    s_table[j] = t;
  }
  float qr[VPL][W];
  const float* qp = q + bh * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = gl + LP * i;
#pragma unroll
    for (int e = 0; e < W; ++e) qr[i][e] = c < Dv ? qp[c * W + e] : 0.f;
  }
  int n = context_lens[b];
  if (n > MAXB * BS) n = MAXB * BS;
  if (n <= 0) {
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = 0.f;
    return;
  }
  if (start >= n) return;             // an empty chunk: weighs nothing
  const int end = min(n, start + chunk);
  const int n_live = (n + chunk - 1) / chunk;
  __syncthreads();

  const size_t row = (size_t)H * Dv;  // T's between positions of a block
  float m = kMask, l = 0.f;
  float acc[VPL][W];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < W; ++e) acc[i][e] = 0.f;

  for (int t0 = start + warp * PW; t0 < end; t0 += kWarps * PW) {
    T kr[SLOTS][VPL], vr[SLOTS][VPL];
    float ks[SLOTS], vs[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int t = t0 + u * G + grp;
      if (t < end) {
        const size_t at = (size_t)s_table[t / BS - blk0] * BS + t % BS;
        const size_t base = at * row + (size_t)h * Dv;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int c = gl + LP * i;
          kr[u][i] = c < Dv ? k_cache[base + c] : T{};
          vr[u][i] = c < Dv ? v_cache[base + c] : T{};
        }
        ks[u] = k_scale[at * H + h];
        vs[u] = v_scale[at * H + h];
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) kr[u][i] = vr[u][i] = T{};
        ks[u] = vs[u] = 0.f;
      }
    }
    float s[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      float dt = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        float f[W];
        to_f32(kr[u][i], f);
#pragma unroll
        for (int e = 0; e < W; ++e) dt += qr[i][e] * f[e];
      }
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1)
        dt += __shfl_xor_sync(0xffffffffu, dt, off);
      // the K scale once on the sum, then the softmax scale
      s[u] = (t0 + u * G + grp < end) ? dt * ks[u] * scale : -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) mx = fmaxf(mx, s[u]);
    const float alpha = expf(m - mx);
    float p[SLOTS], psum = 0.f;
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      p[u] = expf(s[u] - mx);
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
#pragma unroll
      for (int e = 0; e < W; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) {
        float f[W];
        to_f32(vr[u][i], f);
        const float pv = p[u] * vs[u];  // the V scale on the weight
#pragma unroll
        for (int e = 0; e < W; ++e) acc[i][e] += pv * f[e];
      }
    }
    m = mx;
  }

  // the warp's groups, then the CTA's warps, as row 1
#pragma unroll
  for (int off = LP; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, mo);
    const float a = expf(m - mx), c = expf(mo - mx);
    l = l * a + lo * c;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * a + c * other;
      }
    m = mx;
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e) s_acc[warp][(gl + LP * i) * W + e] = acc[i][e];
  }
  __syncthreads();
  cta_finish<kRow>(s_m, s_l, &s_acc[0][0], s_pm, s_pl, &s_last, o, part,
                   count, bh, S, split, n_live, D, tid);
}

template <int W, int LP, int VPL, int SLOTS>
cudaError_t launch_int8(const float* q, const signed char* k,
                        const signed char* v, const float* ks,
                        const float* vs, const int* tables, const int* lens,
                        float* out, float* part, int* count, int B, int H,
                        int D, int NB, int BS, int MAXB, int chunk,
                        int splits, float scale, cudaStream_t stream) {
  using T = typename I8<W>::T;
  const dim3 grid(H, B, splits);
  const size_t smem = (size_t)(chunk / BS + 2) * sizeof(int);
  paged_attention_int8_kernel<W, LP, VPL, SLOTS>
      <<<grid, kThreads, smem, stream>>>(
          q, reinterpret_cast<const T*>(k), reinterpret_cast<const T*>(v),
          ks, vs, tables, lens, out, part, count, H, D, NB, BS, MAXB, chunk,
          scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

// chunk positions a split, splits * chunk covering MAXB * BS and no split
// empty for a full table; part ([B, H, splits, D + 2] floats) and count
// ([B * H] ints, zero before the first launch, left zero by each) are
// read only when splits > 1.
extern "C" cudaError_t paged_attention_f32(
    const float* q, const float* k_cache, const float* v_cache,
    const int* block_tables, const int* context_lens, float* out,
    float* part, int* count, int B, int H, int D, int NB, int BS, int MAXB,
    int chunk, int splits, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || NB <= 0 || BS <= 0 ||
      MAXB <= 0 || MAXB > kMaxTable || B > 65535 || H > 65535 ||
      chunk <= 0 || splits <= 0 || splits > kMaxSplits ||
      (long long)chunk * splits < (long long)MAXB * BS ||
      (long long)chunk * (splits - 1) >= (long long)MAXB * BS ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && D >= 16 && aligned16(q) &&
                   aligned16(k_cache) && aligned16(v_cache);
#define PAGED_ARGS                                                        \
  q, k_cache, v_cache, block_tables, context_lens, out, part, count, B, H, \
      D, NB, BS, MAXB, chunk, splits, scale, stream
  if (vec) {  // LP lanes a position, a float4 each (two past D = 128)
    const int dv = D / 4;
    if (dv <= 4) return launch<float4, 4, 1, 4>(PAGED_ARGS);
    if (dv <= 8) return launch<float4, 8, 1, 4>(PAGED_ARGS);
    if (dv <= 16) return launch<float4, 16, 1, 4>(PAGED_ARGS);
    if (dv <= 32) return launch<float4, 32, 1, 4>(PAGED_ARGS);
    return launch<float4, 32, 2, 2>(PAGED_ARGS);
  }
  // a warp a position, lane + 32 i of its row
  const int ni = (D + 31) / 32;
  if (ni <= 1) return launch<float, 32, 1, 4>(PAGED_ARGS);
  if (ni <= 2) return launch<float, 32, 2, 4>(PAGED_ARGS);
  if (ni <= 4) return launch<float, 32, 4, 4>(PAGED_ARGS);
  return launch<float, 32, 8, 4>(PAGED_ARGS);
#undef PAGED_ARGS
}

// The int8 pools' attention: k_cache / v_cache int8 [NB, BS, H, D],
// k_scale / v_scale f32 [NB, BS, H]; every other argument as
// paged_attention_f32's.
extern "C" cudaError_t paged_attention_int8(
    const float* q, const signed char* k_cache, const signed char* v_cache,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* context_lens, float* out, float* part, int* count, int B,
    int H, int D, int NB, int BS, int MAXB, int chunk, int splits,
    float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || NB <= 0 || BS <= 0 ||
      MAXB <= 0 || MAXB > kMaxTable || B > 65535 || H > 65535 ||
      chunk <= 0 || splits <= 0 || splits > kMaxSplits ||
      (long long)chunk * splits < (long long)MAXB * BS ||
      (long long)chunk * (splits - 1) >= (long long)MAXB * BS ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const bool vec = D % 16 == 0 && aligned16(k_cache) && aligned16(v_cache);
#define INT8_ARGS                                                          \
  q, k_cache, v_cache, k_scale, v_scale, block_tables, context_lens, out, \
      part, count, B, H, D, NB, BS, MAXB, chunk, splits, scale, stream
  if (vec) {  // LP lanes a position, 16 int8 values each; 128 positions a
              // CTA step
    const int dv = D / 16;
    if (dv <= 2) return launch_int8<16, 2, 1, 1>(INT8_ARGS);
    if (dv <= 4) return launch_int8<16, 4, 1, 2>(INT8_ARGS);
    if (dv <= 8) return launch_int8<16, 8, 1, 4>(INT8_ARGS);
    return launch_int8<16, 16, 1, 8>(INT8_ARGS);
  }
  // a warp a position, byte lane + 32 i of its row
  const int ni = (D + 31) / 32;
  if (ni <= 1) return launch_int8<1, 32, 1, 4>(INT8_ARGS);
  if (ni <= 2) return launch_int8<1, 32, 2, 4>(INT8_ARGS);
  if (ni <= 4) return launch_int8<1, 32, 4, 4>(INT8_ARGS);
  return launch_int8<1, 32, 8, 4>(INT8_ARGS);
#undef INT8_ARGS
}
