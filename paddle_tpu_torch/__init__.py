"""PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package imports
``torch`` and numpy only.  Entry points run on the card unless the caller
passes ``device="cpu"`` (or ``CPUPlace()``).  Slices ported so far:

1. greedy decode serving: ``serving.DecodeEngine`` over a paged KV cache,
   its attention step a hand-written CUDA kernel
   (``kernels/csrc/paged_attention.cu``);
2. the Program front end and BERT encoder serving: ``framework``
   (Program/Block/Operator/Variable, the reference's JSON IR),
   ``layers``, ``core`` (op registry, eager Executor, Scope), ``io``
   (``save/load_inference_model`` in the reference's format),
   ``inference`` (AnalysisPredictor) and ``serving.ServingEngine``, with
   CUDA kernels for flash attention, fused residual-add LayerNorm and
   LayerNorm (``kernels/csrc/flash_attention.cu``, ``fused_ln.cu``,
   ``layer_norm.cu``);
3. training on that front end: ``backward`` (``append_backward``),
   ``optimizer`` (Adam), ``ir`` (the optimizer fusion the executor
   applies), the grad ops, and ``models.bert.build_pretrain`` (BERT at
   dropout 0), with CUDA kernels for the attention backward, the fused
   LayerNorm backward and the fused Adam step
   (``kernels/csrc/flash_attention_bwd.cu``, ``fused_ln_bwd.cu``,
   ``fused_adam.cu``);
4. BERT training at its published dropout 0.1: a Philox stream
   (``kernels/philox.py``, ``csrc/philox.cuh``), the ``dropout`` op with
   its mask-drawing kernel (``csrc/dropout.cu``), dropout inside the
   fused-LayerNorm kernels, and the small-sequence attention kernels
   (``csrc/small_attention.cu``, ``small_attention_bwd.cu``) that
   ``FLAGS_fused_small_attention`` routes the flash_attention op to.

``set_flags`` / ``get_flags`` set and read the flags the port has
(``flags.py``)."""

from .device import resolve_device, set_f32_numerics
from .flags import get_flags, set_flags

__all__ = ["resolve_device", "set_f32_numerics", "get_flags", "set_flags"]
