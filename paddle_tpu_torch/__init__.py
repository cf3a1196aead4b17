"""PyTorch / CUDA port of paddle_tpu's decode-serving path for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package imports
``torch`` and numpy only.  Its first slice is greedy autoregressive
decode serving: ``serving.DecodeEngine`` over a paged KV cache whose
attention step runs through a hand-written CUDA kernel
(``kernels/csrc/paged_attention.cu``).  Entry points run on the card
unless the caller passes ``device="cpu"``."""

from .device import resolve_device, set_f32_numerics

__all__ = ["resolve_device", "set_f32_numerics"]
