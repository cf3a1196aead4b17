"""Learning-rate schedules as ops of the program.  Counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``
(``_decay_step_counter:23``, ``noam_decay:61``); the other schedules
(exponential, natural_exp, inverse_time, polynomial, piecewise, cosine,
linear warmup) are not ported yet."""

from ..framework import default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["noam_decay"]


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
