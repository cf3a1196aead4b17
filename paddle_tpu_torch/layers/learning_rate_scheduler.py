"""Learning-rate schedules as ops of the program.  Counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py`` (``_decay_step_counter:23``,
``noam_decay:61``, ``exponential_decay:75``, ``natural_exp_decay:97``,
``inverse_time_decay:112``, ``polynomial_decay:129``,
``piecewise_decay:152``, ``cosine_decay:186``, ``linear_lr_warmup:209``).

Each schedule is elementwise ops over the shared step counter under the
LRSched role, as the reference writes them: no control flow (piecewise
and warmup select with ``less_than`` masks cast to f32) and no read of the
step on the host, so the learning rate stays a [1] tensor on the
executor's device and a step on the card waits for nothing.
"""

import math

from ..framework import default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay",
           "cosine_decay", "linear_lr_warmup"]


def _decay_step_counter(begin=0):
    """The persistable f32 step counter ``@LR_DECAY_COUNTER@``, shared by
    every schedule of the program.  The first call appends its one
    ``increment`` (step 1, LRSched role) at the current end of the main
    program and initialises it to ``begin - 1`` in the startup program:
    the increment runs before the schedule's math each step, so the first
    step reads ``begin``."""
    helper = LayerHelper("global_step_counter")
    counter = helper.create_or_get_global_variable(
        name="@LR_DECAY_COUNTER@", dtype="float32", shape=[1],
        persistable=True)
    counter.stop_gradient = True
    program = default_main_program()
    if not any(op.type == "increment" and op.output("Out") == [counter.name]
               for op in program.global_block().ops):
        Constant(float(begin) - 1.0)(counter)
        with program._lr_schedule_guard():
            program.global_block().append_op(
                type="increment", inputs={"X": [counter]},
                outputs={"Out": [counter]}, attrs={"step": 1.0})
    return counter


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 min(step^-0.5, step warmup_steps^-1.5) (Vaswani et al.
    2017), step counted from 1: a [1] f32 variable the optimizer takes as
    its learning rate."""
    from . import nn

    program = default_main_program()
    with program._lr_schedule_guard():
        step = _decay_step_counter(begin=1)
        a = nn.pow(step, factor=-0.5)
        b = nn.scale(step, scale=warmup_steps ** -1.5)
        lr = nn.scale(nn.elementwise_min(a, b), scale=d_model ** -0.5)
    return lr


def _const(value):
    from . import tensor

    return tensor.fill_constant([1], "float32", float(value))


def _scaled_step(decay_steps, staircase):
    """step / decay_steps, floored under ``staircase``."""
    from . import nn

    div = nn.scale(_decay_step_counter(), scale=1.0 / decay_steps)
    return nn.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """learning_rate decay_rate^(step / decay_steps)."""
    from . import nn

    with default_main_program()._lr_schedule_guard():
        div = _scaled_step(decay_steps, staircase)
        lr = nn.scale(nn.elementwise_pow(_const(decay_rate), div),
                      scale=float(learning_rate))
    return lr


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate exp(-decay_rate step / decay_steps)."""
    from . import nn

    with default_main_program()._lr_schedule_guard():
        div = _scaled_step(decay_steps, staircase)
        ex = nn.exp(nn.scale(div, scale=-decay_rate))
        lr = nn.scale(ex, scale=float(learning_rate))
    return lr


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """learning_rate / (1 + decay_rate step / decay_steps)."""
    from . import nn

    with default_main_program()._lr_schedule_guard():
        div = _scaled_step(decay_steps, staircase)
        denom = nn.scale(div, scale=decay_rate, bias=1.0)
        lr = nn.elementwise_div(_const(learning_rate), denom)
    return lr


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(learning_rate - end) (1 - step / steps)^power + end, steps
    decay_steps with the step capped there, or under ``cycle`` the next
    multiple of decay_steps at or above the step (at least one)."""
    from . import nn

    with default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        if cycle:
            ratio = nn.scale(step, scale=1.0 / decay_steps)
            div = nn.ceil(nn.elementwise_max(ratio, _const(1e-12)))
            steps = nn.scale(div, scale=float(decay_steps))
        else:
            steps = _const(decay_steps)
            step = nn.elementwise_min(step, steps)
        frac = nn.elementwise_div(step, steps)
        one_minus = nn.scale(frac, scale=-1.0, bias=1.0)
        powed = nn.pow(one_minus, factor=power)
        lr = nn.scale(powed, scale=float(learning_rate - end_learning_rate),
                      bias=float(end_learning_rate))
    return lr


def piecewise_decay(boundaries, values):
    """values[i] while boundaries[i - 1] <= step < boundaries[i]: the sum
    of each value times its interval's 0/1 mask."""
    from . import nn, tensor
    from .control_flow import logical_and

    assert len(boundaries) + 1 == len(values)
    with default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        pieces = []
        for i, v in enumerate(values):
            if i == 0:
                cond = step < _const(boundaries[0])
            elif i < len(boundaries):
                lo, hi = _const(boundaries[i - 1]), _const(boundaries[i])
                cond = logical_and(step >= lo, step < hi)
            else:
                cond = step >= _const(boundaries[-1])
            pieces.append(nn.scale(tensor.cast(cond, "float32"),
                                   scale=float(v)))
        lr = pieces[0]
        for piece in pieces[1:]:
            lr = nn.elementwise_add(lr, piece)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """learning_rate (cos(pi epoch / epochs) + 1) / 2, epoch the whole
    epochs done."""
    from . import nn

    with default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        epoch = nn.floor(nn.scale(step, scale=1.0 / step_each_epoch))
        cos_arg = nn.scale(epoch, scale=math.pi / epochs)
        lr = nn.scale(nn.cos(cos_arg), scale=0.5 * learning_rate,
                      bias=0.5 * learning_rate)
    return lr


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr + (end_lr - start_lr) step / warmup_steps while step <
    warmup_steps, then ``learning_rate`` (a number or a schedule's
    variable), selected by the 0/1 mask of ``step < warmup_steps``."""
    from . import nn, tensor

    with default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        wsteps = _const(warmup_steps)
        frac = nn.elementwise_div(nn.elementwise_min(step, wsteps), wsteps)
        warm = nn.scale(frac, scale=float(end_lr - start_lr),
                        bias=float(start_lr))
        in_warm = tensor.cast(step < wsteps, "float32")
        if not hasattr(learning_rate, "name"):
            learning_rate = _const(learning_rate)
        after = nn.elementwise_mul(
            learning_rate, nn.scale(in_warm, scale=-1.0, bias=1.0))
        lr = nn.elementwise_add(nn.elementwise_mul(warm, in_warm), after)
    return lr
