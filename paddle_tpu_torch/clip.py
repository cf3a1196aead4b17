"""Gradient clipping.  Counterpart of ``paddle_tpu/clip.py``
(``ErrorClipByValue:22``, ``GradientClipByValue:29``,
``GradientClipByNorm:50``, ``GradientClipByGlobalNorm:70``,
``set_gradient_clip:117``, ``append_gradient_clip_ops:125``).

A clip maps the (param, grad) pairs to (param, clipped grad), appending
its ops to the program: by value and by norm one ``clip`` /
``clip_by_norm`` op a gradient under the Optimize role; by global norm a
``squared_l2_norm`` a gradient (``<grad>@sq_l2``), their ``sum``
(``global_norm@<group>@var``), its ``sqrt`` and the scale clip_norm /
max(clip_norm, norm) that multiplies every gradient, all under the
Backward role.  The scale is a [1] device tensor, so no step waits on
the host.  The optimizer's update ops then read the clipped variables,
and the fusion pass groups them as it groups raw gradients.

As in the reference, ``set_gradient_clip`` sets one process-wide clip
that every later ``minimize`` without ``grad_clip=`` applies
(``set_gradient_clip(None)`` clears it); without it, a parameter's own
``gradient_clip`` attr clips that parameter's gradient.  An optimizer's
``grad_clip=`` clip wins over both and appends the same ops (the
reference's optimizer calls the clip object itself, which has no
``__call__``, so its ``grad_clip=`` raises a TypeError)."""

from .framework import OpRole, default_main_program

__all__ = ["set_gradient_clip", "ErrorClipByValue", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "append_gradient_clip_ops"]

_clip_attr = {"global": None}


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class ErrorClipByValue:
    """Bounds carried for a variable's error clip; the reference keeps
    them and appends nothing."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class _PerGradientClip(BaseGradientClipAttr):
    """One op a gradient, under the Optimize role."""

    def _clip(self, g):
        raise NotImplementedError

    def _process(self, params_grads):
        program = default_main_program()
        out = []
        for p, g in params_grads:
            if g is not None:
                with program._role_guard(OpRole.Optimize):
                    g = self._clip(g)
            out.append((p, g))
        return out


class GradientClipByValue(_PerGradientClip):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, g):
        from . import layers

        return layers.clip(g, self.min, self.max)


class GradientClipByNorm(_PerGradientClip):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, g):
        from . import layers

        return layers.clip_by_norm(g, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        from . import layers

        program = default_main_program()
        block = program.current_block()
        with program._role_guard(OpRole.Backward):
            norms = []
            for _p, g in params_grads:
                if g is None:
                    continue
                sq = block.create_var(name=g.name + "@sq_l2", shape=(1,),
                                      dtype=g.dtype)
                block.append_op(type="squared_l2_norm", inputs={"X": [g]},
                                outputs={"Out": [sq]})
                norms.append(sq)
            if not norms:
                return params_grads
            total = block.create_var(
                name="global_norm@" + self.group_name + "@var", shape=(1,),
                dtype=norms[0].dtype)
            block.append_op(type="sum", inputs={"X": norms},
                            outputs={"Out": [total]})
            gnorm = layers.sqrt(total)
            clip_var = layers.fill_constant((1,), gnorm.dtype, self.clip_norm)
            scale = layers.elementwise_div(
                clip_var, layers.elementwise_max(clip_var, gnorm))
            return [(p, g if g is None else layers.elementwise_mul(g, scale))
                    for p, g in params_grads]


def set_gradient_clip(clip, param_list=None, program=None):
    """Set the process-wide clip, and with ``param_list`` each of those
    parameters' own attr as well."""
    _clip_attr["global"] = clip
    for p in param_list or ():
        if hasattr(p, "gradient_clip_attr"):
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    """The process-wide clip over every pair if one is set, else each
    parameter's own attr over its pair; unchanged without either."""
    clip = _clip_attr.get("global")
    if clip is not None:
        return clip._process(params_grads)
    out = []
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None)
        if attr is None or g is None:
            out.append((p, g))
        else:
            out.extend(attr._process([(p, g)]))
    return out
