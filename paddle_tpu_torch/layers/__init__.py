"""Layer API of the port (the subset BERT pretraining and the MNIST MLP
call)."""

from .nn import (accuracy, dropout, elementwise_add,  # noqa: F401
                 embedding, fc, flash_attention, fused_dropout_add_ln,
                 gather, layer_norm, matmul, mean, reshape, scale, softmax,
                 softmax_with_cross_entropy, transpose, unsqueeze)
from .tensor import create_global_var, data, fill_constant  # noqa: F401

__all__ = ["accuracy", "create_global_var", "data", "dropout",
           "elementwise_add", "embedding", "fc", "fill_constant",
           "flash_attention", "fused_dropout_add_ln", "gather", "layer_norm",
           "matmul", "mean", "reshape", "scale", "softmax",
           "softmax_with_cross_entropy", "transpose", "unsqueeze"]
