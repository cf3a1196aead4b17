// Fused residual add + LayerNorm for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/fused_ln.py `_fwd_kernel` (launched
// by `_fwd_pallas`) at dropout probability 0, the inference epilogue of
// every BERT encoder layer:
//
//   r = x + y,  z = LayerNorm(r) * gamma + beta,
//   emitting z, r and the f32 row statistics mean and var.
//
// Bound: bytes.  Per row of h floats it must read x and y and write z and
// r (16 h bytes) plus 8 bytes of statistics, ~0.3 flop per byte, far
// below the card's ridge.  Design (ln_rows.cuh): one warp per row with the
// row held in registers, so x and y are read once and the three passes
// (sum, centred square, normalise) never go back to device memory; eight
// rows per 256-thread block.  The TPU kernel's in-kernel dropout
// (pltpu PRNG bits) comes with BERT at dropout 0.1, as a Philox stream.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include "ln_rows.cuh"

extern "C" cudaError_t fused_ln_fwd_f32(const float* x, const float* y,
                                        const float* gamma,
                                        const float* beta, float* z,
                                        float* r, float* mean, float* var,
                                        int n, int h, float eps,
                                        cudaStream_t stream) {
  if (x == nullptr || y == nullptr || r == nullptr)
    return cudaErrorInvalidValue;
  return ln_rows::launch(x, y, gamma, beta, z, r, mean, var, n, h, eps,
                         stream);
}
