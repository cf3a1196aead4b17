"""Layer API of the port (the subset BERT pretraining, ResNet, DLRM and
the MNIST MLP call)."""

from .nn import (accuracy, batch_norm, concat, conv2d,  # noqa: F401
                 conv2d_bn_relu, dropout, elementwise_add, embedding, fc,
                 flash_attention, fused_dropout_add_ln, gather, layer_norm,
                 matmul, mean, pool2d, relu, reshape, scale,
                 sigmoid_cross_entropy_with_logits, softmax,
                 softmax_with_cross_entropy, transpose, unsqueeze)
from .tensor import create_global_var, data, fill_constant  # noqa: F401

__all__ = ["accuracy", "batch_norm", "concat", "conv2d", "conv2d_bn_relu",
           "create_global_var", "data", "dropout",
           "elementwise_add", "embedding", "fc", "fill_constant",
           "flash_attention", "fused_dropout_add_ln", "gather", "layer_norm",
           "matmul", "mean", "pool2d", "relu", "reshape", "scale",
           "sigmoid_cross_entropy_with_logits", "softmax",
           "softmax_with_cross_entropy", "transpose", "unsqueeze"]
