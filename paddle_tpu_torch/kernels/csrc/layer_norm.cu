// LayerNorm forward for Hopper (sm_90a), float32.
//
// Replaces: paddle_tpu/pallas_kernels/layer_norm.py `_ln_fwd_kernel`
// (launched by `_fwd_pallas`):
//
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta over the last dim of
//   x [R, C], emitting y and the f32 row statistics mean and var.
//
// Bound: bytes (read x once, write y once, 8 bytes of statistics per
// row).  Design (ln_rows.cuh, shared with fused_ln.cu): one warp per row
// with the row held in registers, so the statistics and the normalise
// read x from device memory once; eight rows per 256-thread block.
//
// Entry point: plain C, returns the launch's cudaError_t.

#include "ln_rows.cuh"

extern "C" cudaError_t layer_norm_fwd_f32(const float* x, const float* gamma,
                                          const float* beta, float* y,
                                          float* mean, float* var, int rows,
                                          int cols, float eps,
                                          cudaStream_t stream) {
  return ln_rows::launch(x, nullptr, gamma, beta, y, nullptr, mean, var,
                         rows, cols, eps, stream);
}
