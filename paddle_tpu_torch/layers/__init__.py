"""Layer API of the port (the subset BERT pretraining, ResNet, DLRM, the
MNIST MLP, the Transformer's training and beam decode, the AMP
decorator's loss scaling call, the LR schedules, the gradient clips, the
control flow and the recurrent nets), and the operators on Variable
(``math_op_patch``)."""

from . import learning_rate_scheduler  # noqa: F401
from . import math_op_patch  # noqa: F401  (operators on Variable)
from . import tensor  # noqa: F401
from .control_flow import (IfElse, Print, StaticRNN,  # noqa: F401
                           Switch, While, array_length, array_read,
                           array_write, cond, create_array, equal,
                           greater_equal, greater_than, increment, is_empty,
                           less_equal, less_than, logical_and, logical_not,
                           logical_or, logical_xor, not_equal)
from .extra import gather_tree  # noqa: F401
from .learning_rate_scheduler import (cosine_decay,  # noqa: F401
                                      exponential_decay, inverse_time_decay,
                                      linear_lr_warmup, natural_exp_decay,
                                      noam_decay, piecewise_decay,
                                      polynomial_decay)
from .nn import (accuracy, argmax, argmin, batch_norm,  # noqa: F401
                 ceil, clip,
                 clip_by_norm, concat, conv2d, conv2d_bn_relu, cos, dropout,
                 elementwise_add, elementwise_div, elementwise_floordiv,
                 elementwise_max, elementwise_min, elementwise_mod,
                 elementwise_mul, elementwise_pow, elementwise_sub, embedding,
                 exp, expand, fc, flash_attention, floor,
                 fused_dropout_add_ln, gather, label_smooth, layer_norm, log,
                 log_softmax, matmul, mean, one_hot, pool2d, pow,
                 reduce_mean, reduce_sum, relu, reshape, scale, sigmoid,
                 sigmoid_cross_entropy_with_logits, sign, slice, softmax,
                 softmax_with_cross_entropy, split, sqrt, square, squeeze,
                 stack, tanh, topk, transpose, unsqueeze)
from .rnn import (BeamSearchDecoder, GRUCell, LSTMCell,  # noqa: F401
                  RNNCell, beam_search, beam_search_decode, dynamic_decode,
                  dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit, lstm,
                  lstm_unit, rnn)
from .sequence_lod import sequence_mask  # noqa: F401
from .tensor import (assign, cast, create_global_var,  # noqa: F401
                     create_parameter, data, fill_constant,
                     fill_constant_batch_size_like, reverse, zeros)

__all__ = ["accuracy", "argmax", "argmin", "array_length", "array_read",
           "array_write", "assign", "batch_norm", "beam_search",
           "beam_search_decode", "BeamSearchDecoder", "cast", "ceil", "clip",
           "clip_by_norm", "concat", "cond", "conv2d", "conv2d_bn_relu", "cos",
           "cosine_decay", "create_array", "create_global_var",
           "create_parameter", "data", "dropout", "dynamic_decode",
           "dynamic_gru", "dynamic_lstm", "dynamic_lstmp", "elementwise_add",
           "elementwise_div", "elementwise_floordiv", "elementwise_max",
           "elementwise_min", "elementwise_mod", "elementwise_mul",
           "elementwise_pow", "elementwise_sub", "embedding", "equal", "exp",
           "expand", "exponential_decay", "fc", "fill_constant",
           "fill_constant_batch_size_like", "flash_attention", "floor",
           "fused_dropout_add_ln", "gather", "gather_tree", "greater_equal",
           "greater_than", "gru_unit", "GRUCell", "IfElse", "increment",
           "inverse_time_decay", "is_empty", "label_smooth", "layer_norm",
           "less_equal", "less_than", "linear_lr_warmup", "log", "log_softmax",
           "logical_and", "logical_not", "logical_or", "logical_xor", "lstm",
           "lstm_unit", "LSTMCell", "matmul", "mean", "natural_exp_decay",
           "noam_decay", "not_equal", "one_hot", "piecewise_decay",
           "polynomial_decay", "pool2d", "pow", "Print", "reduce_mean",
           "reduce_sum", "relu", "reshape", "reverse", "rnn", "RNNCell",
           "scale", "sequence_mask", "sigmoid",
           "sigmoid_cross_entropy_with_logits", "sign", "slice", "softmax",
           "softmax_with_cross_entropy", "split", "sqrt", "square", "squeeze",
           "stack", "StaticRNN", "Switch", "tanh", "topk", "transpose",
           "unsqueeze", "While", "zeros"]
