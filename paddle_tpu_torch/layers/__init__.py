"""Layer API of the port (the subset BERT pretraining, ResNet, DLRM, the
MNIST MLP and the AMP decorator's loss scaling call), and the operators
on Variable (``math_op_patch``)."""

from . import math_op_patch  # noqa: F401  (operators on Variable)
from .control_flow import (equal, greater_equal, greater_than,  # noqa: F401
                           less_equal, less_than, not_equal)
from .nn import (accuracy, batch_norm, concat, conv2d,  # noqa: F401
                 conv2d_bn_relu, dropout, elementwise_add, elementwise_div,
                 elementwise_floordiv, elementwise_max, elementwise_min,
                 elementwise_mod, elementwise_mul, elementwise_pow,
                 elementwise_sub, embedding, fc, flash_attention,
                 fused_dropout_add_ln, gather, layer_norm, matmul, mean,
                 pool2d, relu, reshape, scale,
                 sigmoid_cross_entropy_with_logits, softmax,
                 softmax_with_cross_entropy, transpose, unsqueeze)
from .tensor import cast, create_global_var, data, fill_constant  # noqa

__all__ = ["accuracy", "batch_norm", "cast", "concat", "conv2d",
           "conv2d_bn_relu", "create_global_var", "data", "dropout",
           "elementwise_add", "elementwise_div", "elementwise_floordiv",
           "elementwise_max", "elementwise_min", "elementwise_mod",
           "elementwise_mul", "elementwise_pow", "elementwise_sub",
           "embedding", "equal", "fc", "fill_constant", "greater_equal",
           "greater_than", "less_equal", "less_than", "not_equal",
           "flash_attention", "fused_dropout_add_ln", "gather", "layer_norm",
           "matmul", "mean", "pool2d", "relu", "reshape", "scale",
           "sigmoid_cross_entropy_with_logits", "softmax",
           "softmax_with_cross_entropy", "transpose", "unsqueeze"]
