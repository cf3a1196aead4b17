"""Gradient clipping: the path ``Optimizer.apply_gradients`` runs when no
clip is set.  Counterpart of ``paddle_tpu/clip.py``
(``append_gradient_clip_ops:125``); the clip attrs come with a model
that uses them."""

__all__ = ["append_gradient_clip_ops"]


def append_gradient_clip_ops(params_grads):
    """With no per-parameter clip attr the pairs pass through unchanged."""
    for p, _g in params_grads:
        if getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(
                "gradient clipping is not ported yet (param %r)" % p.name)
    return params_grads
