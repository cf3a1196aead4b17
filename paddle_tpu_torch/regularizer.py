"""Weight-decay regularizers.  Counterpart of ``paddle_tpu/regularizer.py``
(``L2DecayRegularizer:14``, ``L1DecayRegularizer:25``,
``append_regularization_ops:36``): the L2 decay, which ResNet's
``Momentum(regularization=L2Decay(1e-4))`` uses, and the L1 decay,
coeff * sign(param)."""

from .framework import OpRole, default_main_program

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class L2DecayRegularizer:
    """decay = coeff * param, one ``scale`` op."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from . import layers

        return layers.scale(param, scale=self._coeff)


class L1DecayRegularizer:
    """decay = coeff * sign(param): a ``sign`` op, then a ``scale``."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        from . import layers

        return layers.scale(layers.sign(param), scale=self._coeff)


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += the decay of each regularized param (its own regularizer,
    else ``regularization``): the decay op, then a ``sum`` whose Out is
    the gradient variable itself, both under the Optimize role as the
    reference appends them.  The executor runs the sum as a rewrite of
    the gradient's value, which the update op after it reads."""
    program = default_main_program()
    block = program.current_block()
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            continue
        with program._role_guard(OpRole.Optimize):
            decay = reg(param, grad, block)
            block.append_op(type="sum", inputs={"X": [grad, decay]},
                            outputs={"Out": [grad]})
    return list(parameters_and_grads)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
