"""Layer API of the port (the subset BERT pretraining, ResNet, DLRM, the
MNIST MLP, the Transformer's training and beam decode and the AMP
decorator's loss scaling call), and the operators on Variable
(``math_op_patch``)."""

from . import learning_rate_scheduler  # noqa: F401
from . import math_op_patch  # noqa: F401  (operators on Variable)
from . import tensor  # noqa: F401
from .control_flow import (While, array_write, cond,  # noqa: F401
                           create_array, equal, greater_equal, greater_than,
                           increment, less_equal, less_than, not_equal)
from .nn import (accuracy, batch_norm, concat, conv2d,  # noqa: F401
                 conv2d_bn_relu, dropout, elementwise_add, elementwise_div,
                 elementwise_floordiv, elementwise_max, elementwise_min,
                 elementwise_mod, elementwise_mul, elementwise_pow,
                 elementwise_sub, embedding, expand, fc, flash_attention,
                 fused_dropout_add_ln, gather, label_smooth, layer_norm,
                 log_softmax, matmul, mean, one_hot, pool2d, pow, reduce_sum,
                 relu, reshape, scale, sigmoid_cross_entropy_with_logits,
                 slice, softmax, softmax_with_cross_entropy, transpose,
                 unsqueeze)
from .rnn import beam_search, beam_search_decode  # noqa: F401
from .tensor import (assign, cast, create_global_var, data,  # noqa: F401
                     fill_constant, fill_constant_batch_size_like, zeros)

__all__ = ["accuracy", "array_write", "assign", "batch_norm", "beam_search",
           "beam_search_decode", "cast", "concat", "cond", "conv2d",
           "conv2d_bn_relu", "create_array", "create_global_var", "data",
           "dropout", "elementwise_add", "elementwise_div",
           "elementwise_floordiv", "elementwise_max", "elementwise_min",
           "elementwise_mod", "elementwise_mul", "elementwise_pow",
           "elementwise_sub", "embedding", "equal", "expand", "fc",
           "fill_constant", "fill_constant_batch_size_like",
           "flash_attention", "fused_dropout_add_ln", "gather",
           "greater_equal", "greater_than", "increment", "label_smooth",
           "layer_norm", "less_equal", "less_than", "log_softmax", "matmul",
           "mean", "not_equal", "one_hot", "pool2d", "pow", "reduce_sum",
           "relu", "reshape", "scale", "sigmoid_cross_entropy_with_logits",
           "slice", "softmax", "softmax_with_cross_entropy", "transpose",
           "unsqueeze", "While", "zeros"]
