"""Composite network blocks (Fluid's nets.py: simple_img_conv_pool:28,
img_conv_group:138, sequence_conv_pool:251, glu:319,
scaled_dot_product_attention:360): compositions of layers, the same
calls as ``paddle_tpu/nets.py``, so both packages build the same program.
``sequence_conv_pool`` raises: it waits for the sequence ops (ROADMAP
A9)."""

from . import layers

__all__ = [
    "simple_img_conv_pool", "sequence_conv_pool", "glu",
    "scaled_dot_product_attention", "img_conv_group",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Stacked conv [+BN] [+dropout] blocks followed by one pool
    (nets.py:138, the VGG building block)."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v, name):
        if isinstance(v, (list, tuple)):
            assert len(v) == len(conv_num_filter), (
                "%s length %d must match conv_num_filter length %d"
                % (name, len(v), len(conv_num_filter)))
            return list(v)
        return [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding, "conv_padding")
    conv_filter_size = _expand(conv_filter_size, "conv_filter_size")
    param_attr = _expand(param_attr, "param_attr")
    conv_with_batchnorm = _expand(conv_with_batchnorm,
                                  "conv_with_batchnorm")
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate,
                                       "conv_batchnorm_drop_rate")

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    raise NotImplementedError(
        "nets.sequence_conv_pool builds sequence_conv and sequence_pool, "
        "which the port does not have yet: they come with the sequence ops "
        "of the long tail (ROADMAP A9)")


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)
    (nets.py:319)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(x=b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention (nets.py:360): q/k/v are
    [B, T, D]; returns [B, Tq, Dv] context."""
    for name, t in (("queries", queries), ("keys", keys),
                    ("values", values)):
        if t.shape is None or len(t.shape) != 3:
            raise ValueError(
                "%s must be a 3-D [batch, time, hidden] tensor, got shape "
                "%s" % (name, t.shape))
    if not (queries.shape[-1] % num_heads == 0
            and values.shape[-1] % num_heads == 0):
        raise ValueError(
            "num_heads (%d) must divide the hidden sizes (%s, %s)"
            % (num_heads, queries.shape[-1], values.shape[-1]))

    def _split_heads(x):
        if num_heads == 1:
            return x
        B_T_D = x.shape
        reshaped = layers.reshape(
            x, shape=[B_T_D[0] or -1, B_T_D[1], num_heads,
                      B_T_D[2] // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def _merge_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        s = t.shape
        return layers.reshape(t, shape=[s[0] or -1, s[1], s[2] * s[3]])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    key_dim = float(queries.shape[-1] // num_heads)
    scaled_q = layers.scale(q, scale=key_dim ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx)
