"""MNIST MLP classifier.  Counterpart of ``paddle_tpu/models/mnist.py``
(``build_mlp:7``): the same layer calls, so both packages build the same
program."""

from .. import layers

__all__ = ["build_mlp"]


def build_mlp(img_shape=(784,), num_classes=10):
    """-> (img, label, logits, loss, acc); no optimizer."""
    img = layers.data("img", shape=list(img_shape))
    label = layers.data("label", shape=[1], dtype="int64")
    h = layers.fc(img, 200, act="relu")
    h = layers.fc(h, 200, act="relu")
    logits = layers.fc(h, num_classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return img, label, logits, loss, acc
