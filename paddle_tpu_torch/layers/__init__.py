"""Layer API of the port (the subset the BERT encoder calls)."""

from .nn import (elementwise_add, embedding, fc, flash_attention,  # noqa
                 fused_dropout_add_ln, layer_norm, matmul, reshape, scale,
                 transpose, unsqueeze)
from .tensor import data  # noqa: F401

__all__ = ["data", "elementwise_add", "embedding", "fc", "flash_attention",
           "fused_dropout_add_ln", "layer_norm", "matmul", "reshape", "scale",
           "transpose", "unsqueeze"]
