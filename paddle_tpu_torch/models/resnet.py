"""ResNet for ImageNet, v1.5 bottlenecks (the stride on the 3x3 conv).

Counterpart of ``paddle_tpu/models/resnet.py`` (``conv_bn:19``,
``basic_block:34``, ``bottleneck_block:47``, ``resnet:63``,
``build_train:91``): the same layer calls (conv2d + batch_norm pairs,
Momentum with L2 decay; ``amp=True`` decorates the Momentum with the bf16
AMP policy, as ``paddle_tpu/models/resnet.py:112-113``), so both packages
build the same programs.  The port runs NCHW; the channels-last variant
raises (ROADMAP A: layouts).
"""

from .. import layers
from ..contrib import mixed_precision
from ..optimizer import Momentum
from ..regularizer import L2Decay

__all__ = ["DEPTH_CFG", "conv_bn", "basic_block", "bottleneck_block",
           "resnet", "build_train"]

DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _check_layout(data_format):
    if data_format != "NCHW":
        raise NotImplementedError(
            "ResNet data_format %r: the port builds NCHW; channels-last is "
            "not ported yet (ROADMAP)" % (data_format,))


def conv_bn(x, filters, size, stride=1, act=None, is_test=False, name=None,
            data_format="NCHW"):
    c = layers.conv2d(x, filters, size, stride=stride,
                      padding=(size - 1) // 2, bias_attr=False, name=name,
                      data_format=data_format)
    return layers.batch_norm(c, act=act, is_test=is_test,
                             data_layout=data_format)


def basic_block(x, filters, stride, is_test=False, data_format="NCHW"):
    conv0 = conv_bn(x, filters, 3, stride, act="relu", is_test=is_test)
    conv1 = conv_bn(conv0, filters, 3, 1, is_test=is_test)
    shortcut = x
    if stride != 1 or x.shape[1] != filters:
        shortcut = conv_bn(x, filters, 1, stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(conv1, shortcut))


def bottleneck_block(x, filters, stride, is_test=False, data_format="NCHW"):
    conv0 = conv_bn(x, filters, 1, 1, act="relu", is_test=is_test)
    conv1 = conv_bn(conv0, filters, 3, stride, act="relu", is_test=is_test)
    conv2 = conv_bn(conv1, filters * 4, 1, 1, is_test=is_test)
    shortcut = x
    if stride != 1 or x.shape[1] != filters * 4:
        shortcut = conv_bn(x, filters * 4, 1, stride, is_test=is_test)
    return layers.relu(layers.elementwise_add(conv2, shortcut))


def resnet(img, class_dim=1000, depth=50, is_test=False, data_format="NCHW"):
    """Logits of an NCHW ``img``."""
    _check_layout(data_format)
    kind, counts = DEPTH_CFG[depth]
    block_fn = basic_block if kind == "basic" else bottleneck_block
    x = conv_bn(img, 64, 7, 2, act="relu", is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    for stage, n in enumerate(counts):
        for i in range(n):
            x = block_fn(x, 64 * 2 ** stage, 2 if (i == 0 and stage > 0)
                         else 1, is_test=is_test)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(x, class_dim)


def build_train(depth=50, class_dim=1000, image_size=224, lr=0.1,
                momentum=0.9, weight_decay=1e-4, is_test=False, amp=False,
                data_format="NCHW"):
    """-> (img, label, loss, acc) inside the current program guard; with
    ``is_test`` False, Momentum(lr, momentum, L2Decay(weight_decay)) has
    minimised the loss, decorated by ``mixed_precision.decorate`` under
    ``amp``."""
    _check_layout(data_format)
    img = layers.data("img", shape=[3, image_size, image_size])
    label = layers.data("label", shape=[1], dtype="int64")
    logits = resnet(img, class_dim, depth, is_test=is_test)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    if not is_test:
        opt = Momentum(learning_rate=lr, momentum=momentum,
                       regularization=L2Decay(weight_decay))
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return img, label, loss, acc
