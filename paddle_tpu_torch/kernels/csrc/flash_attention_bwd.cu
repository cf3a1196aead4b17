// Flash attention backward for Hopper (sm_90a), float32: two kernels, as
// the TPU's recompute scheme has.
//
// Replaces: paddle_tpu/pallas_kernels/flash_attention.py `_bwd_dq_kernel`
// and `_bwd_dkv_kernel` (both launched by `_bwd_pallas`).  Same function:
// with s = (q . k) * scale + bias, s = -1e30 where causal and j > i (the
// forward's masking, flash_attention.cu), lse the forward's row
// log-sum-exp and delta = rowsum(dO * O) (one torch expression, as the
// reference computes it outside its kernels):
//
//   p  = exp(s - lse)                  recomputed, never stored
//   ds = p * (dO . v - delta) * scale
//   dQ = ds @ k,   dK = ds^T @ q,   dV = p^T @ dO
//
// A fully masked row (every s at the finite -1e30) has lse = -1e30 in f32,
// where -1e30 + log(Sk) is not representable, so exp(s - lse) is 1 for
// every column; the forward averaged V over that row, and p is scaled by
// 1 / Sk there (lse < -1e29) to match it.
//
// Bound: operations.  dQ does 6 and dK/dV 8 multiply-adds per (i, j, d),
// 28 * B*H*Sq*Sk*D flops against the bytes of q, k, v, dO, bias, lse,
// delta and the three gradients; at BERT's S = 128, D = 64 that is ~60
// flops per byte, above the card's ~20 f32 flop/byte ridge.  Design, a
// simple right one first (the tensor cores, through wgmma/TMA, are a
// later step):
//   * the TPU's sequential grid axis becomes a loop inside the CTA and
//     nothing carries between CTAs, so neither kernel needs atomics:
//     dQ runs one 256-thread CTA per (b, h, 64-row q tile) looping over
//     64-column k tiles; dK/dV one CTA per (b, h, 64-row k tile) looping
//     over 64-row q tiles;
//   * every tile is read once per CTA into shared memory, rows padded by
//     one float so the dot products over D fall in distinct banks;
//   * thread (rg, cg) owns a 4 x 4 block of the score tile (rows
//     4rg..4rg+3, columns cg + 16j), computing s and dO . v together;
//     p or ds go through shared memory into the tile products, where the
//     same thread owns 4 rows x ceil(D / 16) columns of the gradient;
//   * causal: tiles wholly above the diagonal are skipped.
// q, k, v and dO are read through (batch, head, row) strides with unit
// stride along D, so the head-split transposes need no copy; bias, lse,
// delta and the gradients are contiguous.
//
// Entry points: plain C, each launches one kernel and returns its
// cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kB = 64;  // rows of a q tile and of a k tile
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr float kMask = -1e30f;
constexpr float kMaskedRow = -1e29f;  // lse below this: a fully masked row
constexpr int ldp = kB + 1;

struct Strides {
  long long b, h, s;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, Sq, Sk, D, bias_heads, causal;
  float scale;
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ const float* head_bias(const Args& a, int b,
                                                  int h) {
  if (a.bias_heads == 0) return nullptr;
  return a.bias + ((size_t)b * a.bias_heads + (a.bias_heads > 1 ? h : 0)) *
                      (size_t)a.Sq * a.Sk;
}

// p of score x in a row whose lse is lr (see the masked-row note above)
__device__ __forceinline__ float prob(float x, float lr, float inv_sk) {
  const float p = expf(x - lr);
  return lr < kMaskedRow ? p * inv_sk : p;
}

// rows [r0, r0 + kB) of a strided [S, D] head into a padded tile
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int S, int D, int tid) {
  const int ld = D + 1;
  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r0 + r < S ? src[(r0 + r) * row_stride + d] : 0.f;
  }
}

template <int DC>  // DC = ceil(D / 16) gradient columns per thread
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, Sq = a.Sq, Sk = a.Sk;
  const int ld = D + 1;
  float* sQ = smem;          // kB x ld
  float* sO = sQ + kB * ld;  // dO tile
  float* sK = sO + kB * ld;
  float* sV = sK + kB * ld;
  float* sS = sV + kB * ld;  // ds, kB x ldp

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const size_t head = (size_t)b * a.H + h;
  const float* bb = head_bias(a, b, h);
  const float inv_sk = 1.f / (float)Sk;

  load_tile(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, Sq, D, tid);
  load_tile(sO, a.dout + b * a.os.b + h * a.os.h, a.os.s, q0, Sq, D, tid);
  float lr[4], dl[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    lr[i] = row < Sq ? a.lse[head * Sq + row] : 0.f;
    dl[i] = row < Sq ? a.delta[head * Sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nkt = (Sk + kB - 1) / kB;
  if (a.causal) nkt = min(nkt, (min(Sq, q0 + kB) - 1) / kB + 1);
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kB;
    const int kvalid = min(kB, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(sK, kb, a.ks.s, k0, Sk, D, tid);
    load_tile(sV, vb, a.vs.s, k0, Sk, D, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(rg * 4 + i) * ld + d];
        ov[i] = sO[(rg * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(cg + 16 * j) * ld + d];
        vv[j] = sV[(cg + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float ds = 0.f;
        if (col < Sk && row < Sq) {
          float x = s[i][j] * a.scale;  // scale after the dot, as forward
          if (bb != nullptr) x += bb[(size_t)row * Sk + col];
          if (a.causal && col > row) x = kMask;
          const float p = prob(x, lr[i], inv_sk);
          ds = p * (dp[i][j] - dl[i]) * a.scale;
        }
        sS[(rg * 4 + i) * ldp + cg + 16 * j] = ds;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kvalid; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(rg * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = cg + 16 * c;
        const float kvv = d < D ? sK[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += dsv[i] * kvv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    float* o = a.dq + (head * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = cg + 16 * c;
      if (d < D) o[d] = acc[i][c];
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, Sq = a.Sq, Sk = a.Sk;
  const int ld = D + 1;
  float* sK = smem;          // kB x ld
  float* sV = sK + kB * ld;
  float* sQ = sV + kB * ld;
  float* sO = sQ + kB * ld;  // dO tile
  float* sP = sO + kB * ld;  // p^T, kB (k rows) x ldp (q columns)
  float* sS = sP + kB * ldp;  // ds^T
  float* sL = sS + kB * ldp;  // lse of the q tile's rows
  float* sD = sL + kB;        // delta of the q tile's rows

  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // k rows 4rg .. 4rg+3 of the tile
  const int cg = tid & 15;  // q columns cg + 16j
  const size_t head = (size_t)b * a.H + h;
  const float* bb = head_bias(a, b, h);
  const float inv_sk = 1.f / (float)Sk;

  load_tile(sK, a.k + b * a.ks.b + h * a.ks.h, a.ks.s, k0, Sk, D, tid);
  load_tile(sV, a.v + b * a.vs.b + h * a.vs.h, a.vs.s, k0, Sk, D, tid);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nqt = (Sq + kB - 1) / kB;
  // causal: q rows before k0 see none of this tile's keys
  const int qt0 = a.causal ? k0 / kB : 0;
  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* ob = a.dout + b * a.os.b + h * a.os.h;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * kB;
    const int qvalid = min(kB, Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(sQ, qb, a.qs.s, q0, Sq, D, tid);
    load_tile(sO, ob, a.os.s, q0, Sq, D, tid);
    if (tid < kB) {
      const bool in = tid < qvalid;
      sL[tid] = in ? a.lse[head * Sq + q0 + tid] : 0.f;
      sD[tid] = in ? a.delta[head * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(rg * 4 + i) * ld + d];
        vv[i] = sV[(rg * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(cg + 16 * j) * ld + d];
        ov[j] = sO[(cg + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[j] * kv[i];
          dp[i][j] += ov[j] * vv[i];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = cg + 16 * j;
        const int qrow = q0 + qc;
        float p = 0.f, ds = 0.f;
        if (qrow < Sq && krow < Sk) {
          float x = s[i][j] * a.scale;
          if (bb != nullptr) x += bb[(size_t)qrow * Sk + krow];
          if (a.causal && krow > qrow) x = kMask;
          p = prob(x, sL[qc], inv_sk);
          ds = p * (dp[i][j] - sD[qc]) * a.scale;
        }
        sP[(rg * 4 + i) * ldp + qc] = p;
        sS[(rg * 4 + i) * ldp + qc] = ds;
      }
    }
    __syncthreads();

    for (int qq = 0; qq < qvalid; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(rg * 4 + i) * ldp + qq];
        dsv[i] = sS[(rg * 4 + i) * ldp + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = cg + 16 * c;
        const float ov = d < D ? sO[qq * ld + d] : 0.f;
        const float qv = d < D ? sQ[qq * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] += pv[i] * ov;
          dk[i][c] += dsv[i] * qv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + rg * 4 + i;
    if (krow >= Sk) continue;
    float* gk = a.dk + (head * Sk + krow) * D;
    float* gv = a.dv + (head * Sk + krow) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = cg + 16 * c;
      if (d < D) {
        gk[d] = dk[i][c];
        gv[d] = dv[i][c];
      }
    }
  }
}

constexpr size_t dq_smem(int D) {
  return sizeof(float) * ((size_t)4 * kB * (D + 1) + (size_t)kB * ldp);
}

constexpr size_t dkv_smem(int D) {
  return sizeof(float) *
         ((size_t)4 * kB * (D + 1) + (size_t)2 * kB * ldp + 2 * kB);
}

// Each kernel's dynamic shared-memory limit is raised once per device, to
// what its largest D (16 * DC) needs, so that a launch costs no attribute
// call.
template <typename Kernel>
cudaError_t ensure_smem_limit(Kernel kernel, size_t bytes,
                              std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int DC>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};  // bit i: device i
  cudaError_t err =
      ensure_smem_limit(flash_bwd_dq_kernel<DC>, dq_smem(16 * DC), done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kB - 1) / kB, a.H, B);
  flash_bwd_dq_kernel<DC><<<grid, kThreads, dq_smem(a.D), stream>>>(a);
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch_dkv(const Args& a, int B, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err =
      ensure_smem_limit(flash_bwd_dkv_kernel<DC>, dkv_smem(16 * DC), done);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kB - 1) / kB, a.H, B);
  flash_bwd_dkv_kernel<DC><<<grid, kThreads, dkv_smem(a.D), stream>>>(a);
  return cudaGetLastError();
}

bool valid(const Args& a, int B) {
  return B > 0 && a.H > 0 && a.Sq > 0 && a.Sk > 0 && a.D > 0 &&
         a.D <= kMaxD && B <= 65535 && a.H <= 65535 &&
         (a.bias_heads == 0 || a.bias_heads == 1 || a.bias_heads == a.H) &&
         (a.bias_heads == 0 || a.bias != nullptr);
}

Args make_args(const float* q, const float* k, const float* v,
               const float* bias, const float* dout, const float* lse,
               const float* delta, int H, int Sq, int Sk, int D,
               int bias_heads, int causal, float scale, const long long* st) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = a.dk = a.dv = nullptr;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.bias_heads = bias_heads;
  a.causal = causal;
  a.scale = scale;
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.os = Strides{st[9], st[10], st[11]};
  return a;
}

}  // namespace

// strides: 12 values, (batch, head, row) of q, k, v and dO in turn
extern "C" cudaError_t flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dq,
    int B, int H, int Sq, int Sk, int D, int bias_heads, int causal,
    float scale, const long long* strides, cudaStream_t stream) {
  Args a = make_args(q, k, v, bias, dout, lse, delta, H, Sq, Sk, D,
                     bias_heads, causal, scale, strides);
  a.dq = dq;
  if (!valid(a, B) || dq == nullptr) return cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 1: return launch_dq<1>(a, B, stream);
    case 2: return launch_dq<2>(a, B, stream);
    case 3: return launch_dq<3>(a, B, stream);
    case 4: return launch_dq<4>(a, B, stream);
    case 5: return launch_dq<5>(a, B, stream);
    case 6: return launch_dq<6>(a, B, stream);
    case 7: return launch_dq<7>(a, B, stream);
    default: return launch_dq<8>(a, B, stream);
  }
}

extern "C" cudaError_t flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* dout, const float* lse, const float* delta, float* dk,
    float* dv, int B, int H, int Sq, int Sk, int D, int bias_heads,
    int causal, float scale, const long long* strides, cudaStream_t stream) {
  Args a = make_args(q, k, v, bias, dout, lse, delta, H, Sq, Sk, D,
                     bias_heads, causal, scale, strides);
  a.dk = dk;
  a.dv = dv;
  if (!valid(a, B) || dk == nullptr || dv == nullptr)
    return cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 1: return launch_dkv<1>(a, B, stream);
    case 2: return launch_dkv<2>(a, B, stream);
    case 3: return launch_dkv<3>(a, B, stream);
    case 4: return launch_dkv<4>(a, B, stream);
    case 5: return launch_dkv<5>(a, B, stream);
    case 6: return launch_dkv<6>(a, B, stream);
    case 7: return launch_dkv<7>(a, B, stream);
    default: return launch_dkv<8>(a, B, stream);
  }
}
