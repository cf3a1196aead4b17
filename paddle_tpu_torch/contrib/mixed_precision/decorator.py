"""The mixed-precision optimizer decorator.  Counterpart of
``paddle_tpu/contrib/mixed_precision/decorator.py``
(``OptimizerWithMixedPrecision:21``, ``backward:59``,
``_append_scale_update:116``, ``decorate:164``).

The policy is the reference's, not the fp16 cast rewrite of the Fluid it
imitates: ``backward`` sets ``program._amp_bf16``, which the product
lowerings read (bf16 operands, bf16 results, f32 sums), and adds static
or dynamic loss scaling built without branches from the same ops in the
same order as the reference, so a decorated program equals the
reference's through ``to_dict()``.  Dynamic scaling: one ``isfinite``
over every gradient; on overflow the unscaled gradients are zero (the
update a near no-op) and the scale shrinks by ``decr_ratio``; after
``incr_every_n_steps`` finite steps it grows by ``incr_ratio``.
"""

from ...framework import OpRole
from ...initializer import Constant
from ...utils import unique_name
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling_var = None
        self._scaled_loss = None

    def get_loss_scaling(self):
        return self._loss_scaling_var

    def get_scaled_loss(self):
        return self._scaled_loss

    def _create_scale_var(self, block):
        var = block.create_var(
            name=unique_name.generate("loss_scaling"),
            shape=(1,), dtype="float32", persistable=True)
        var.stop_gradient = True
        Constant(self._init_loss_scaling)(var)
        self._loss_scaling_var = var
        good = block.create_var(
            name=unique_name.generate("good_steps"),
            shape=(1,), dtype="float32", persistable=True)
        good.stop_gradient = True
        Constant(0.0)(good)
        self._good_steps_var = good
        return var

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """Flag the program, scale the loss, differentiate, and unscale
        the gradients -> [(param, grad)]."""
        from ... import layers

        program = loss.block.program
        block = program.global_block()
        program._amp_bf16 = True

        dynamic = self._use_dynamic_loss_scaling
        static_scale = self._init_loss_scaling != 1.0 and not dynamic
        if dynamic:
            scale_var = self._create_scale_var(block)
            self._scaled_loss = layers.elementwise_mul(loss, scale_var)
        elif static_scale:
            self._scaled_loss = layers.scale(loss,
                                             scale=self._init_loss_scaling)
        else:
            self._scaled_loss = loss

        params_grads = self._optimizer.backward(
            self._scaled_loss, startup_program, parameter_list, no_grad_set)
        if not (dynamic or static_scale):
            return params_grads

        with program._role_guard(OpRole.Backward):
            if not dynamic:
                return [(p, g if g is None else layers.scale(
                    g, scale=1.0 / self._init_loss_scaling))
                    for p, g in params_grads]
            # one all-finite flag over every gradient
            grads = [g for _, g in params_grads if g is not None]
            fin = block.create_var(
                name=unique_name.generate("all_grads_finite"),
                shape=(1,), dtype="bool")
            block.append_op(type="isfinite", inputs={"X": grads},
                            outputs={"Out": [fin]})
            fin_f = layers.cast(fin, "float32")
            # 1 / scale, or 0 on overflow
            inv_scale = layers.elementwise_div(fin_f,
                                               self._loss_scaling_var)
            unscaled = [(p, g if g is None else
                         layers.elementwise_mul(g, inv_scale))
                        for p, g in params_grads]
            self._append_scale_update(fin_f)
            return unscaled

    def _append_scale_update(self, fin_f):
        """good' = (good + 1) fin; scale' = fin (good' >= N ? scale incr :
        scale) + (1 - fin) scale decr; good'' = good' reset to 0 at N."""
        from ... import layers

        scale_var = self._loss_scaling_var
        good = self._good_steps_var
        one_minus = layers.scale(fin_f, scale=-1.0, bias=1.0)
        good_next = layers.elementwise_mul(
            layers.scale(good, bias=1.0), fin_f)
        n = layers.fill_constant([1], "float32",
                                 float(self._incr_every_n_steps))
        reached = layers.cast(good_next >= n, "float32")
        not_reached = layers.scale(reached, scale=-1.0, bias=1.0)
        grown = layers.scale(scale_var, scale=self._incr_ratio)
        shrunk = layers.scale(scale_var, scale=self._decr_ratio)
        keep_or_grow = layers.elementwise_add(
            layers.elementwise_mul(grown, reached),
            layers.elementwise_mul(scale_var, not_reached))
        new_scale = layers.elementwise_add(
            layers.elementwise_mul(keep_or_grow, fin_f),
            layers.elementwise_mul(shrunk, one_minus))
        new_good = layers.elementwise_mul(good_next, not_reached)
        block = scale_var.block
        block.append_op(type="assign", inputs={"X": [new_scale]},
                        outputs={"Out": [scale_var]})
        block.append_op(type="assign", inputs={"X": [new_good]},
                        outputs={"Out": [good]})

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False):
    """Wrap ``optimizer`` for bf16 mixed-precision training."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio)
