"""Weight-decay regularizers: the path ``Optimizer.apply_gradients`` runs
when neither the optimizer nor any parameter sets one.  Counterpart of
``paddle_tpu/regularizer.py`` (``append_regularization_ops``); the L1/L2
decays come with a model that uses them."""

__all__ = ["append_regularization_ops"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += the decay of each regularized param; with none set the
    pairs pass through unchanged."""
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is not None and reg is not None:
            raise NotImplementedError(
                "weight-decay regularizers are not ported yet (param %r)"
                % param.name)
    return list(parameters_and_grads)
