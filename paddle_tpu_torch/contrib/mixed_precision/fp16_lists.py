"""Op lists of the mixed-precision policy.  Counterpart of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py``: kept for the API;
no lowering reads them (the policy is bf16 operands in the products,
``LowerCtx.amp_bf16``)."""

__all__ = ["AutoMixedPrecisionLists", "white_list", "black_list",
           "gray_list"]

white_list = {"conv2d", "matmul", "mul", "depthwise_conv2d"}

black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim",
    "softmax", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "cross_entropy", "cross_entropy2",
    "layer_norm",
}

gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow", "elementwise_mod",
    "batch_norm", "tanh", "sigmoid", "relu", "relu6", "leaky_relu", "gelu",
    "dropout", "pool2d", "transpose2", "reshape2", "concat", "split", "slice",
    "scale", "cast", "stack", "squeeze2", "unsqueeze2", "top_k", "flatten2",
    "lookup_table", "lookup_table_v2", "gather", "pad",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
