"""Optimizers: the ``Optimizer`` base, SGD, Momentum and Adam.

Counterpart of ``paddle_tpu/optimizer.py`` (``Optimizer:77``:
``_create_global_learning_rate:88``, ``_add_accumulator:149``,
``minimize:169``, ``backward:176``, ``apply_gradients:214``;
``SGDOptimizer:262``; ``MomentumOptimizer:278``; ``AdamOptimizer:366``;
``SGD``, ``Momentum``, ``Adam``).  ``minimize`` is ``append_backward``, then the clip pass (a
no-op without clipping) and the regularization pass (``regularizer.py``:
a decay op and an in-place ``sum`` into each regularized gradient), then
one update op per parameter, appended under the Optimize role exactly
as the reference appends them, so the programs are the reference's.
The executor later fuses the sgd, momentum and adam ops of rank <= 2
into one ``fused_sgd`` / ``fused_momentum`` / ``fused_adam``
(``ir.FuseOptimizerOpsPass``).  The
other optimizers of the reference come with models that use them.
"""

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import OpRole, Variable, default_main_program
from .initializer import Constant
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "AdamOptimizer", "SGD", "Momentum", "Adam"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._learning_rate_map = {}
        self._accumulators = {}  # accum name -> {param name: var}

    # -- learning rate -------------------------------------------------

    def _create_global_learning_rate(self):
        program = default_main_program()
        if self._learning_rate_map.get(program) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr = program.global_block().create_var(
            name=unique_name.generate("learning_rate"), shape=(1,),
            dtype="float32", persistable=True)
        lr.stop_gradient = True
        Constant(float(self._learning_rate))(lr)
        self._learning_rate_map[program] = lr

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        if param.optimize_attr.get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError(
                "a per-parameter learning rate needs the scale op under the "
                "LRSched role, not ported yet (param %r)" % param.name)
        return self._global_learning_rate()

    # -- accumulators ----------------------------------------------------

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        accum = self._accumulators.setdefault(name, {})
        if param.name in accum:
            return accum[param.name]
        var = default_main_program().global_block().create_var(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True)
        var.stop_gradient = True
        Constant(float(fill_value))(var)
        accum[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- main --------------------------------------------------------------

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        if self._grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, params_grads):
        program = default_main_program()
        self._create_global_learning_rate()
        self._create_accumulators(
            program.global_block(),
            [p for p, g in params_grads if g is not None])
        target_block = program.current_block()
        optimize_ops = []
        for param_and_grad in params_grads:
            if param_and_grad[1] is None or not param_and_grad[0].trainable:
                continue
            with program._role_guard(OpRole.Optimize):
                optimize_ops.append(
                    self._append_optimize_op(target_block, param_and_grad))
        return optimize_ops

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            type="momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            type="adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
