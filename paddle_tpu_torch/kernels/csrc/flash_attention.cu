// Flash attention forward for Hopper (sm_90a), float32, on the tensor
// cores in 3xTF32.
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
// Bound: 4*B*H*Sq*Sk*D flops against (q+k+v+bias+out+lse) bytes.  On the
// f32 SIMT pipes (67 TF/s) BERT's S = 128, D = 64 is operations-bound
// (~32 flops a byte against a ~20 flop/byte ridge); in 3xTF32 on the
// tensor cores (three TF32 products per f32 product at 495 TF/s) it is
// bytes-bound: at B = 8, 13.1 MB take 0.0039 ms at 3.35 TB/s, the 1.21
// GFLOP of TF32 products 0.0024 ms.
//
// Design: the core in flash_fwd.cuh (shared with the small-sequence
// forward, small_attention.cu), instantiated without the dropout mask:
// 3xTF32 `mma.sync.m16n8k8`, one CTA of NW warps per (b, h, 16 NW query
// rows) walking 32-key tiles through a 2-stage cp.async ring, the scores
// and the online softmax in the accumulator fragments, p fed to p . v
// from registers.  A CTA owns 64 rows by default (4 warps: 147 registers,
// 73 KB of shared memory, 3 CTAs an SM at D <= 64); 32 and 128 rows (2,
// 8 warps) are built for sweeps and checks (flash_attention.py
// `FWD_WARPS`).  Causal: key tiles wholly above the CTA's last row are
// skipped.
// q, k and v are read through (batch, head, row) strides with unit
// stride along D, so a transposed view needs no copy; bias, out and lse
// are contiguous.
//
// Entry points: plain C, each returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include "flash_fwd.cuh"

// warps: the CTA's warps, 2, 4 or 8 (flash_attention.py `FWD_WARPS`)
extern "C" cudaError_t flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, float* lse, int B, int H, int Sq, int Sk, int D,
    int bias_heads, int causal, float scale, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int warps,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > flash_fwd::kMaxD || B > 65535 || H > 65535 ||
      (bias_heads != 0 && bias_heads != 1 && bias_heads != H) ||
      (bias_heads != 0 && bias == nullptr) || !flash_fwd::aligned16(out))
    return cudaErrorInvalidValue;
  const flash_fwd::Args a = flash_fwd::make_args(
      q, k, v, bias, out, lse, H, Sq, Sk, D, bias_heads, causal, scale, q_sb,
      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  switch (warps) {
    case 2: return flash_fwd::launch_d<2, false>(a, B, stream);
    case 4: return flash_fwd::launch_d<4, false>(a, B, stream);
    case 8: return flash_fwd::launch_d<8, false>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// CTAs of the kernel for (D, warps) resident on one SM at once (reports)
extern "C" cudaError_t flash_attention_fwd_ctas_per_sm(int D, int warps,
                                                       int* n) {
  switch (warps) {
    case 2: return flash_fwd::ctas_d<2, false>(D, n);
    case 4: return flash_fwd::ctas_d<4, false>(D, n);
    case 8: return flash_fwd::ctas_d<8, false>(D, n);
    default: return cudaErrorInvalidValue;
  }
}
