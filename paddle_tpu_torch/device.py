"""Device selection for the PyTorch port.

Every entry point of ``paddle_tpu_torch`` takes ``device=None``, which
means the CUDA card.  The CPU runs only when a caller asks for it by
name (the tests do), so a missing card is an error and never a silent
fallback."""

import torch

__all__ = ["resolve_device", "set_f32_numerics"]


def resolve_device(device=None):
    """``None`` -> ``cuda``; anything else -> ``torch.device(device)``.
    A CUDA device on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def set_f32_numerics():
    """The JAX reference computes in full float32, and so does the port:
    TF32 keeps about three decimal digits and would drift the decode
    logits away from the reference.  PyTorch leaves matmul TF32 off by
    default but convolutions on, so both are set explicitly.  Under the
    bf16 AMP policy the products take bf16 operands and keep f32 sums, as
    the reference's (the MXU accumulates in f32), so cuBLAS may not reduce
    a split sum in bf16 either."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
