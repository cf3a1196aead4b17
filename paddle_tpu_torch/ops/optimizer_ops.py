"""Optimizer update ops: sgd, momentum, adam and their fused forms, and
adamax, adagrad, decayed_adagrad, adadelta, rmsprop, lars_momentum,
lamb and ftrl.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` (``sgd:22``,
``momentum:36``, ``adam:50``, ``adamax:86``, ``adagrad:103``,
``decayed_adagrad:116``, ``adadelta:129``, ``rmsprop:146``,
``lars_momentum:168``, ``lamb:189``, ``ftrl:214``, ``fused_sgd:307``,
``fused_momentum:332``, ``fused_adam:367``).  Scalars enter
the arithmetic as f32 tensors, as the reference's
``jnp.asarray(beta1, dt)`` does, so each update is the same sequence of
f32 operations.  ``adam`` returns new tensors;
``fused_adam`` (what ``ir.FuseOptimizerOpsPass`` makes of a group of
adam ops) reaches the fused-Adam kernel, which updates the parameters,
moments and beta pows in place on the card; ``fused_momentum`` reaches
the fused-momentum kernel the same way, except under an l2_decay
attribute, which keeps the plain path as in the reference.  ``sgd`` and
``fused_sgd`` are plain PyTorch, as the reference's are jnp: one
subtraction of ``lr g`` per element, new tensors.

Under the bf16 AMP policy an op's Param slot reads a carried param's f32
master (``core.lowering``), its grad may be bf16 (a carried weight's
grad is in the copy's dtype) and is cast to f32 before the update, as
the reference's ``fused_opt.py:142-149`` does; the fused kernels write
the new bf16 copy of each carried member in the same pass
(``_carry_buffers``), which the reference's kernels stash for the same
use (``stash_bf16_carry``).
"""

import torch

from ..core.registry import register_op
from ..kernels.fused_adam import fused_adam_step
from ..kernels.fused_momentum import fused_momentum_step


def _f32(grads, dtype):
    return [g if g.dtype == dtype else g.to(dtype) for g in grads]


def _carry_buffers(ctx):
    """Per member of the op's Param slot: the bf16 copy of a carried
    param (its buffer, which the kernel overwrites on the card), else
    None; None when no member is carried."""
    carry = ctx.carry
    if not carry:
        return None
    bufs = [carry.get(n) for n in ctx.op.input("Param")]
    return bufs if any(b is not None for b in bufs) else None


def _hand_carry(ctx, bufs, copies):
    """Record the new bf16 copies the kernel (or its plain version)
    wrote for the carried members."""
    if bufs is None:
        return
    for n, b, c in zip(ctx.op.input("Param"), bufs, copies):
        if b is not None:
            ctx.carry[n] = c
            ctx.carry_written.add(n)

@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), grad_maker=None)
def sgd(ctx, param, grad, lr):
    return param - lr.reshape(()).to(param.dtype) * grad.to(param.dtype)


@register_op("fused_sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), duplicable_inputs=("Param", "Grad"),
             duplicable_outputs=("ParamOut",), grad_maker=None)
def fused_sgd(ctx, params, grads, lr):
    """One SGD step over the group (what ``ir.FuseOptimizerOpsPass``
    makes of the sgd ops), member by member: the reference's flat-buffer
    update is elementwise, so the values are the same."""
    if ctx.abstract:  # shape inference: the outputs are the inputs
        return (params,)
    lr_ = lr.reshape(()).to(params[0].dtype)
    return ([p - lr_ * g.to(p.dtype) for p, g in zip(params, grads)],)


_MOMENTUM_ATTRS = {"mu": 0.0, "use_nesterov": False,
                   "regularization_method": "", "regularization_coeff": 0.0}


def _momentum_update(p, g, v, lr, mu, use_nesterov, regularization_method,
                     regularization_coeff):
    """The reference's unfused recurrence in f32, returning new tensors:
    an l2_decay attribute folds coeff * p into g first."""
    g = g.to(p.dtype)
    if regularization_method == "l2_decay":
        g = g + regularization_coeff * p
    vn = mu * v + g
    if use_nesterov:
        return p - (g + mu * vn) * lr, vn
    return p - lr * vn, vn


@register_op("momentum", inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), attrs=_MOMENTUM_ATTRS,
             grad_maker=None)
def momentum(ctx, param, grad, velocity, lr, mu=0.0, use_nesterov=False,
             regularization_method="", regularization_coeff=0.0):
    return _momentum_update(param, grad, velocity,
                            lr.reshape(()).to(param.dtype), mu, use_nesterov,
                            regularization_method, regularization_coeff)


@register_op("fused_momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"),
             duplicable_inputs=("Param", "Grad", "Velocity"),
             duplicable_outputs=("ParamOut", "VelocityOut"),
             attrs=_MOMENTUM_ATTRS, grad_maker=None)
def fused_momentum(ctx, params, grads, vels, lr, mu=0.0, use_nesterov=False,
                   regularization_method="", regularization_coeff=0.0):
    """One momentum step over the group.  Without an l2_decay attribute
    (ResNet's L2Decay comes as appended scale + sum ops, so its attribute
    is empty) it is the fused kernel, in place on the card: ParamOut and
    VelocityOut names equal Param and Velocity names."""
    if ctx.abstract:  # shape inference: the outputs are the inputs
        return params, vels
    grads = _f32(grads, params[0].dtype)
    if regularization_method != "l2_decay":
        bufs = _carry_buffers(ctx)
        p, v, copies = fused_momentum_step(params, grads, vels, lr, mu,
                                           use_nesterov, bufs)
        _hand_carry(ctx, bufs, copies)
        return p, v
    lr_ = lr.reshape(()).to(params[0].dtype)
    pv = [_momentum_update(p, g, v, lr_, mu, use_nesterov,
                           regularization_method, regularization_coeff)
          for p, g, v in zip(params, grads, vels)]
    return [p for p, _ in pv], [v for _, v in pv]


@register_op("adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow", "Beta1Tensor", "Beta2Tensor"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"),
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                    "lazy_mode": False,
                    "min_row_size_to_use_multithread": 1000},
             optional_inputs=("Beta1Tensor", "Beta2Tensor"),
             grad_maker=None)
def adam(ctx, param, grad, m1, m2, lr, b1pow, b2pow, b1t, b2t, beta1=0.9,
         beta2=0.999, epsilon=1e-8, **_):
    dt, dev = param.dtype, param.device

    def scalar(t, value):
        return t.reshape(()).to(dt) if t is not None \
            else torch.tensor(value, dtype=dt, device=dev)

    b1, b2 = scalar(b1t, beta1), scalar(b2t, beta2)
    g = grad.to(dt)
    m1n = b1 * m1 + (1.0 - b1) * g
    m2n = b2 * m2 + (1.0 - b2) * g * g
    b1p = b1pow.reshape(()).to(dt)
    b2p = b2pow.reshape(()).to(dt)
    lr_t = lr.reshape(()).to(dt) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    p = param - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    return (p, m1n, m2n, (b1pow * b1).to(b1pow.dtype),
            (b2pow * b2).to(b2pow.dtype))


@register_op("fused_adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"),
             duplicable_inputs=("Param", "Grad", "Moment1", "Moment2",
                                "Beta1Pow", "Beta2Pow"),
             duplicable_outputs=("ParamOut", "Moment1Out", "Moment2Out",
                                 "Beta1PowOut", "Beta2PowOut"),
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             grad_maker=None)
def fused_adam(ctx, params, grads, m1s, m2s, lr, b1pows, b2pows, beta1=0.9,
               beta2=0.999, epsilon=1e-8):
    """One Adam step over the group, each member with its own bias
    correction (beta pows may diverge).  On the card the outputs are the
    inputs, updated in place: ParamOut names equal Param names."""
    if ctx.abstract:  # shape inference: the outputs are the inputs
        return (params, m1s, m2s, b1pows, b2pows)
    bufs = _carry_buffers(ctx)
    p, m1, m2, b1o, b2o, copies = fused_adam_step(
        params, _f32(grads, params[0].dtype), m1s, m2s, lr, b1pows, b2pows,
        beta1, beta2, epsilon, bufs)
    _hand_carry(ctx, bufs, copies)
    return p, m1, m2, b1o, b2o


# -- the other update rules ---------------------------------------------------
#
# Plain PyTorch, as the reference's are jnp (no pallas_call, no fusion
# group).  Each computes every new value from the old state first, then
# writes it into the state tensors in place, so the outputs are the
# scope's own tensors (ParamOut names equal Param names).


def _in_place(ctx, *pairs):
    """(state tensor, its new value) pairs -> the state tensors, each
    overwritten by its new value; the new values themselves during shape
    inference."""
    if ctx.abstract:
        return tuple(new for _old, new in pairs)
    return tuple(old.copy_(new) for old, new in pairs)


def _norm(x):
    """sqrt(sum(x^2)) as a device scalar (LARS's and Lamb's whole-tensor
    norms)."""
    return torch.sqrt(torch.sum(x * x))


@register_op("adamax",
             inputs=("Param", "Grad", "Moment", "InfNorm", "LearningRate",
                     "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut"),
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             grad_maker=None)
def adamax(ctx, param, grad, moment, inf_norm, lr, b1pow, beta1=0.9,
           beta2=0.999, epsilon=1e-8):
    """The beta1 pow is not advanced here: the optimizer's
    ``_finish_update`` appends a scale op for it."""
    m = beta1 * moment + (1.0 - beta1) * grad
    inf = torch.maximum(beta2 * inf_norm, torch.abs(grad) + epsilon)
    lr_t = lr.reshape(()) / (1.0 - b1pow.reshape(()))
    return _in_place(ctx, (param, param - lr_t * m / inf), (moment, m),
                     (inf_norm, inf))


@register_op("adagrad", inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), attrs={"epsilon": 1e-6},
             grad_maker=None)
def adagrad(ctx, param, grad, moment, lr, epsilon=1e-6):
    m = moment + grad * grad
    p = param - lr.reshape(()) * grad / (torch.sqrt(m) + epsilon)
    return _in_place(ctx, (param, p), (moment, m))


@register_op("decayed_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"),
             attrs={"decay": 0.95, "epsilon": 1e-6}, grad_maker=None)
def decayed_adagrad(ctx, param, grad, moment, lr, decay=0.95, epsilon=1e-6):
    m = decay * moment + (1.0 - decay) * grad * grad
    p = param - lr.reshape(()) * grad / (torch.sqrt(m) + epsilon)
    return _in_place(ctx, (param, p), (moment, m))


@register_op("adadelta",
             inputs=("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
             attrs={"rho": 0.95, "epsilon": 1e-6}, grad_maker=None)
def adadelta(ctx, param, grad, avg_sq_grad, avg_sq_update, rho=0.95,
             epsilon=1e-6):
    """No learning rate: the step is sqrt(E[dx^2] / E[g^2]) g."""
    g2 = rho * avg_sq_grad + (1.0 - rho) * grad * grad
    update = -torch.sqrt((avg_sq_update + epsilon) / (g2 + epsilon)) * grad
    u2 = rho * avg_sq_update + (1.0 - rho) * update * update
    return _in_place(ctx, (param, param + update), (avg_sq_grad, g2),
                     (avg_sq_update, u2))


@register_op("rmsprop",
             inputs=("Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
                     "LearningRate"),
             outputs=("ParamOut", "MomentOut", "MeanSquareOut",
                      "MeanGradOut"),
             attrs={"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10,
                    "centered": False},
             optional_inputs=("MeanGrad",), grad_maker=None)
def rmsprop(ctx, param, grad, mean_square, mean_grad, moment, lr, decay=0.9,
            momentum=0.0, epsilon=1e-10, centered=False):
    """Centered: the mean gradient's square comes off the mean square;
    MeanGrad is left as it is otherwise."""
    lr = lr.reshape(())
    ms = decay * mean_square + (1.0 - decay) * grad * grad
    if centered:
        mg = decay * mean_grad + (1.0 - decay) * grad
        mom = momentum * moment + lr * grad / torch.sqrt(ms - mg * mg
                                                         + epsilon)
    else:
        mom = momentum * moment + lr * grad / torch.sqrt(ms + epsilon)
    p, mom, ms = _in_place(ctx, (param, param - mom), (moment, mom),
                           (mean_square, ms))
    if centered:
        mean_grad, = _in_place(ctx, (mean_grad, mg))
    return p, mom, ms, mean_grad


@register_op("lars_momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"),
             attrs={"mu": 0.0, "lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                    "epsilon": 0.0},
             grad_maker=None)
def lars_momentum(ctx, param, grad, velocity, lr, mu=0.0, lars_coeff=0.001,
                  lars_weight_decay=0.0005, epsilon=0.0):
    """You et al. 2017: the layer's rate lr lars_coeff ||p|| / (||g|| +
    wd ||p||), the + 1e-20 keeping a zero layer finite, as the
    reference's."""
    p_norm, g_norm = _norm(param), _norm(grad)
    local_lr = lr.reshape(()) * lars_coeff * p_norm / (
        g_norm + lars_weight_decay * p_norm + epsilon + 1e-20)
    v = mu * velocity + local_lr * (grad + lars_weight_decay * param)
    return _in_place(ctx, (param, param - v), (velocity, v))


@register_op("lamb",
             inputs=("Param", "Grad", "Moment1", "Moment2", "LearningRate",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"),
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                    "weight_decay": 0.01},
             grad_maker=None)
def lamb(ctx, param, grad, m1, m2, lr, b1pow, b2pow, beta1=0.9, beta2=0.999,
         epsilon=1e-6, weight_decay=0.01):
    """You et al. 2019: Adam's bias-corrected step plus the weight decay,
    scaled by the trust ratio ||p|| / ||r|| (1 where either is 0); the
    beta pows advance here, unlike Adamax's."""
    m1n = beta1 * m1 + (1.0 - beta1) * grad
    m2n = beta2 * m2 + (1.0 - beta2) * grad * grad
    m1h = m1n / (1.0 - b1pow.reshape(()))
    m2h = m2n / (1.0 - b2pow.reshape(()))
    r = m1h / (torch.sqrt(m2h) + epsilon) + weight_decay * param
    w_norm, r_norm = _norm(param), _norm(r)
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    p = param - lr.reshape(()) * ratio * r
    return _in_place(ctx, (param, p), (m1, m1n), (m2, m2n),
                     (b1pow, b1pow * beta1), (b2pow, b2pow * beta2))


@register_op("ftrl",
             inputs=("Param", "SquaredAccumulator", "LinearAccumulator",
                     "Grad", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
             attrs={"l1": 0.0, "l2": 0.0, "lr_power": -0.5}, grad_maker=None)
def ftrl(ctx, param, sq_accum, lin_accum, grad, lr, l1=0.0, l2=0.0,
         lr_power=-0.5):
    """McMahan et al. 2013, the reference's form: sqrt for the default
    lr_power -0.5, pow otherwise."""
    lr = lr.reshape(())
    new_accum = sq_accum + grad * grad
    if lr_power == -0.5:
        new_root, old_root = torch.sqrt(new_accum), torch.sqrt(sq_accum)
    else:
        new_root = torch.pow(new_accum, -lr_power)
        old_root = torch.pow(sq_accum, -lr_power)
    sigma = (new_root - old_root) / lr
    lin = lin_accum + grad - sigma * param
    denom = new_root / lr + 2 * l2
    pre = torch.clamp(lin, -l1, l1) - lin
    p = torch.where(torch.abs(lin) > l1, pre / denom, torch.zeros_like(param))
    return _in_place(ctx, (param, p), (sq_accum, new_accum),
                     (lin_accum, lin))
