"""Optimizers: the ``Optimizer`` base, the eleven update rules, the
averaging wrappers (EMA, ModelAverage, Lookahead), gradient merge and the
three wrappers still to come.

Counterpart of ``paddle_tpu/optimizer.py`` (``Optimizer:75``:
``_create_global_learning_rate:88``, ``_create_param_lr:125``,
``_add_accumulator:149``, ``minimize:169``, ``apply_gradients:214``,
``_finish_update:255``; ``SGDOptimizer:262``, ``MomentumOptimizer:278``,
``LarsMomentumOptimizer:306``, ``AdagradOptimizer:337``,
``AdamOptimizer:366``, ``AdamaxOptimizer:415``,
``DecayedAdagradOptimizer:465``, ``AdadeltaOptimizer:490``,
``RMSPropOptimizer:516``, ``FtrlOptimizer:550``, ``LambOptimizer:579``,
``ExponentialMovingAverage:614``, ``ModelAverage:677``,
``GradientMergeOptimizer:754``, ``LookaheadOptimizer:837``).
``minimize`` is ``append_backward``, then the clip pass (the
optimizer's ``grad_clip``, else ``clip.py``'s) and the regularization
pass (``regularizer.py``: a decay op and an in-place
``sum`` into each regularized gradient), then one update op per
parameter under the Optimize role, each reading its parameter's
learning rate (the global one, or a ``scale`` of it under the LRSched
role where the parameter's ``learning_rate`` attr is not 1), then the
rule's finishing ops (Adamax's beta-pow scale), exactly as the reference
appends them, so the programs are the reference's and a reference
scope's state (accumulators named ``<param>_<accum>_<n>`` by the same
``unique_name`` calls) carries across with ``scope_from_numpy``.

The executor later fuses the sgd, momentum and adam ops of rank <= 2
that share a learning-rate variable into one ``fused_sgd`` /
``fused_momentum`` / ``fused_adam`` (``ir.FuseOptimizerOpsPass``), as the
reference fuses only those three; the other rules run one op a
parameter (``ops/optimizer_ops.py``).
"""

import contextlib

import torch

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import (OpRole, Variable, default_main_program,
                        default_startup_program)
from .initializer import Constant
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "Adamax",
           "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "Lamb",
           "SGDOptimizer", "MomentumOptimizer", "DGCMomentumOptimizer",
           "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
           "DecayedAdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "FtrlOptimizer", "LambOptimizer",
           "LarsMomentum", "LarsMomentumOptimizer", "GradientMergeOptimizer",
           "ExponentialMovingAverage", "ModelAverage", "RecomputeOptimizer",
           "LookaheadOptimizer", "PipelineOptimizer"]


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
        """The global learning rate, or for a parameter whose
        ``learning_rate`` attr is not 1 a ``scale`` of it (LRSched role),
        its own variable: the fusion pass groups by that variable."""
        base = self._global_learning_rate()
        param_lr = param_and_grad[0].optimize_attr.get("learning_rate", 1.0)
        if param_lr == 1.0:
            return base
        from . import layers

        with default_main_program()._lr_schedule_guard():
            return layers.scale(base, scale=float(param_lr))

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
            params_grads = self._grad_clip._process(params_grads)
        else:
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
        with program._role_guard(OpRole.Optimize):
            self._finish_update(target_block, params_grads)
        return optimize_ops

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
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



class LarsMomentumOptimizer(Optimizer):
    """Momentum with LARS's layer-wise rate (``lars_momentum``); its
    weight decay is the op's, not a regularizer's."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    """The ``adamax`` op leaves the beta1 pow alone; ``_finish_update``
    appends one ``scale`` a parameter that advances it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        inf_norm = self._get_accumulator("inf_norm", param)
        return block.append_op(
            type="adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "InfNorm": [inf_norm],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc",
                                                       param)]},
            outputs={"ParamOut": [param], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for p, g in params_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(type="scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """No learning-rate input: the ``adadelta`` op takes none, so the
    global learning rate is made but not read."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        g2 = self._get_accumulator("__avg_squared_grad", param)
        u2 = self._get_accumulator("__avg_squared_update", param)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [g2], "AvgSquaredUpdate": [u2]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [g2],
                     "AvgSquaredUpdateOut": [u2]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        mom = self._get_accumulator("momentum", param)
        ms = self._get_accumulator("mean_square", param)
        mg = self._get_accumulator("mean_grad", param)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param], "Grad": [grad], "Moment": [mom],
                    "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """Adam's accumulators; the ``lamb`` op applies the weight decay, 0
    for a parameter ``exclude_from_weight_decay_fn`` returns True for
    (BERT's recipe: LayerNorm scales and shifts and the biases)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            type="lamb",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


# -- averaging wrappers -----------------------------------------------------


def _trainable_params():
    return [p for p in default_main_program().global_block().all_parameters()
            if p.trainable]


def _persistable_like(block, p, suffix):
    """A persistable variable shaped as ``p``, named
    ``<p>.<suffix>_<n>``."""
    return block.create_var(name=unique_name.generate(p.name + suffix),
                            shape=p.shape, dtype=p.dtype, persistable=True)


class _SwapGuard:
    """Swaps each parameter's tensor in the global scope for another
    tensor while a ``with`` lasts, then puts the originals back
    (``need_restore``), or keeps them for ``restore``."""

    def _swap(self, values, need_restore):
        from .core.executor import global_scope

        scope = global_scope()
        self._backup = {}
        for name, value in values.items():
            self._backup[name] = scope.find_var(name).get_tensor().get()
            scope.var(name).set(value)
        try:
            yield
        finally:
            if need_restore:
                self.restore(None)

    def restore(self, executor):
        """Put back the parameters the last ``apply`` swapped out."""
        from .core.executor import global_scope

        scope = global_scope()
        for name, value in getattr(self, "_backup", {}).items():
            scope.var(name).set(value)
        self._backup = {}


class ExponentialMovingAverage(_SwapGuard):
    """ema = decay ema + (1 - decay) param, per trainable parameter of the
    main program when it is built (``<param>.ema_<n>``, from 0, no bias
    correction; ``thres_steps`` is taken and unused, as in the
    reference).  ``update()`` appends the ops, after ``minimize`` so they
    read the updated parameters; ``apply`` swaps the averages in."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars = {}
        block = default_main_program().global_block()
        self._params = _trainable_params()
        for p in self._params:
            ema = _persistable_like(block, p, ".ema")
            Constant(0.0)(ema)
            self._ema_vars[p.name] = ema

    def update(self):
        from . import layers

        block = default_main_program().global_block()
        for p in self._params:
            ema = self._ema_vars[p.name]
            block.append_op(type="scale", inputs={"X": [ema]},
                            outputs={"Out": [ema]},
                            attrs={"scale": self._decay})
            tmp = layers.scale(p, scale=1.0 - self._decay)
            block.append_op(type="elementwise_add",
                            inputs={"X": [ema], "Y": [tmp]},
                            outputs={"Out": [ema]})

    def apply(self, executor, need_restore=True):
        """A context in which each parameter holds (a copy of) its EMA."""
        from .core.executor import global_scope

        scope = global_scope()
        values = {}
        for p in self._params:
            ema = scope.find_var(self._ema_vars[p.name].name)
            if ema is not None:
                values[p.name] = ema.get_tensor().get().clone()
        return contextlib.contextmanager(self._swap)(values, need_restore)


class ModelAverage(Optimizer, _SwapGuard):
    """The running sum of each trainable parameter and a step count,
    updated by ops appended to the main program when it is built (so
    build it after ``minimize``): ``<param>.avg_sum_<n>`` and
    ``avg_count_<n>``; ``apply`` swaps in sum / max(count, 1), computed
    on the device.  The window arguments are taken and unused, as in the
    reference's simplified form."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self._sums = {}
        block = default_main_program().global_block()
        self._params = _trainable_params()
        for p in self._params:
            s = _persistable_like(block, p, ".avg_sum")
            Constant(0.0)(s)
            self._sums[p.name] = s
            block.append_op(type="elementwise_add",
                            inputs={"X": [s], "Y": [p]}, outputs={"Out": [s]})
        cnt = block.create_var(name=unique_name.generate("avg_count"),
                               shape=(1,), dtype="float32", persistable=True)
        Constant(0.0)(cnt)
        block.append_op(type="increment", inputs={"X": [cnt]},
                        outputs={"Out": [cnt]}, attrs={"step": 1.0})
        self._count = cnt

    def apply(self, executor, need_restore=True):
        """A context in which each parameter holds its average."""
        from .core.executor import global_scope

        scope = global_scope()
        cnt = torch.clamp(scope.find_var(self._count.name).get_tensor().get(),
                          min=1.0)
        values = {p.name: scope.find_var(self._sums[p.name].name)
                  .get_tensor().get() / cnt for p in self._params}
        return contextlib.contextmanager(self._swap)(values, need_restore)


class LookaheadOptimizer:
    """Lookahead (Zhang et al. 2019) as the reference builds it: a slow
    copy of each parameter (``<param>.slow_<n>``, an ``assign`` of the
    parameter in the startup program), moved every step by alpha / k of
    its gap to the fast weights after the inner optimizer's update, the
    reference's static-graph smoothing of the k-step sync."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from . import layers

        ops, pgs = self.inner_optimizer.minimize(loss, startup_program)
        block = default_main_program().global_block()
        sb = default_startup_program().global_block()
        for p, g in pgs:
            if g is None:
                continue
            slow = _persistable_like(block, p, ".slow")
            for v in (slow, p):
                if not sb.has_var(v.name):
                    sb.create_var(name=v.name, shape=p.shape, dtype=p.dtype,
                                  persistable=True)
            sb.append_op(type="assign", inputs={"X": [p.name]},
                         outputs={"Out": [slow.name]})
            upd = layers.scale(layers.elementwise_sub(p, slow),
                               scale=self.alpha / self.k)
            block.append_op(type="elementwise_add",
                            inputs={"X": [slow], "Y": [upd]},
                            outputs={"Out": [slow]})
        return ops, pgs


class GradientMergeOptimizer:
    """Gradient accumulation (the reference's ``GradientMergeOptimizer``,
    ``paddle_tpu/optimizer.py:754``): every step adds each gradient into a
    persistable ``<param>.merged_grad_<n>`` buffer and steps an int64
    counter; a ``Switch`` on ``counter % k_steps == 0`` applies the inner
    optimizer to the merged gradients (divided by ``k_steps`` under
    ``avg``) and zeroes the buffers, so k micro-batches update as one
    k-times-larger batch.  The inner optimizer's accumulators and learning
    rate land in the global block; its update ops, and any clip or
    regularization ops it appends, in the branch, whose ``Out`` slot
    lists every persistable they write.  ``k_steps == 1`` is the inner
    optimizer.  The update ops stay unfused, as the reference fuses only
    the global block's."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if k_steps < 1:
            raise ValueError("k_steps must be >= 1")
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """``grad_clip`` is taken and unused, as in the reference."""
        from . import layers

        if self.k_steps == 1:
            return self.inner_optimizer.minimize(
                loss, startup_program, parameter_list, no_grad_set)
        params_grads = self.inner_optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)
        block = loss.block.program.global_block()
        counter = layers.create_global_var(
            shape=[1], value=0, dtype="int64", persistable=True,
            name=unique_name.generate("gradient_merge_step"))
        layers.increment(counter, value=1, in_place=True)
        merged = []
        for p, g in params_grads:
            if g is None:
                continue
            # no "@GRAD" in the name: a buffer that lives across steps,
            # never the implicit zero of a missing gradient
            m = block.create_var(
                name=unique_name.generate(p.name + ".merged_grad"),
                shape=p.shape, dtype=p.dtype, persistable=True)
            m.stop_gradient = True
            Constant(0.0)(m)
            block.append_op(type="elementwise_add",
                            inputs={"X": [m.name], "Y": [g.name]},
                            outputs={"Out": [m.name]}, attrs={})
            merged.append((p, m))
        k_var = layers.fill_constant(shape=[1], dtype="int64",
                                     value=self.k_steps)
        zero = layers.fill_constant(shape=[1], dtype="int64", value=0)
        is_boundary = layers.equal(layers.elementwise_mod(counter, k_var),
                                   zero)
        ops = None
        sw = layers.Switch()
        with sw.case(is_boundary):
            ops = self.inner_optimizer.apply_gradients(
                [(p, layers.scale(m, scale=1.0 / self.k_steps)
                  if self.avg else m) for p, m in merged])
            for _p, m in merged:
                layers.assign(layers.scale(m, scale=0.0), m)
        with sw.default():
            pass
        return ops, params_grads


# -- wrappers that wait for other items -------------------------------------


def _waits_for(name, what):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "%s is not ported yet: it waits for %s" % (name, what))

    return type(name, (), {"__init__": __init__,
                           "__doc__": "Not ported yet: waits for %s." % what})


RecomputeOptimizer = _waits_for(
    "RecomputeOptimizer", "recompute segments (ROADMAP A7)")
PipelineOptimizer = _waits_for(
    "PipelineOptimizer", "the port's parallel/ (ROADMAP A9)")
DGCMomentumOptimizer = _waits_for(
    "DGCMomentumOptimizer", "the port's collectives (ROADMAP A8)")


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
