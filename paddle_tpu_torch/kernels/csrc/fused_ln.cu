// Fused dropout + residual add + LayerNorm for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/fused_ln.py `_fwd_kernel` (launched
// by `_fwd_pallas`), the epilogue of every BERT encoder layer:
//
//   y' = keep ? y * inv_q : 0   (p > 0; y' = y at p = 0)
//   r = x + y',  z = LayerNorm(r) * gamma + beta,
//   emitting z, r and the f32 row statistics mean and var.
//
// The keep draw is the TPU kernel's contract (keep iff u32 < thr, thr =
// round((1 - p) 2^32), inv_q = 2^32 / thr) with the Philox stream of
// philox.cuh in place of the TPU core's generator: element row * h + col,
// keyed by the op's two seed words, which the kernel also stores to the
// op's Seed output for the backward (fused_ln_bwd.cu) to replay.
//
// Bound: bytes.  Per row of h floats it must read x and y and write z and
// r (16 h bytes) plus 8 bytes of statistics, ~0.3 flop per byte, far
// below the card's ridge; at p > 0 one Philox4x32-10 per element (its
// lane of four) adds ~50 integer operations an element.  Design
// (ln_rows.cuh): one warp per row with the row held in registers, so x
// and y are read once and the three passes (sum, centred square,
// normalise) never go back to device memory; eight rows per 256-thread
// block.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include "ln_rows.cuh"

// thr == 0: no dropout (k0, k1, inv_q unused); seed_out may be null
extern "C" cudaError_t fused_ln_fwd_f32(const float* x, const float* y,
                                        const float* gamma,
                                        const float* beta, float* z,
                                        float* r, float* mean, float* var,
                                        int n, int h, float eps,
                                        unsigned int thr, unsigned int k0,
                                        unsigned int k1, float inv_q,
                                        int* seed_out, cudaStream_t stream) {
  if (x == nullptr || y == nullptr || r == nullptr)
    return cudaErrorInvalidValue;
  ln_rows::Drop dp;
  dp.thr = thr;
  dp.k0 = k0;
  dp.k1 = k1;
  dp.inv_q = inv_q;
  return ln_rows::launch(x, y, gamma, beta, z, r, mean, var, n, h, eps,
                         stream, dp, seed_out);
}
