"""Control-flow ops: ``while``, ``conditional_block``, ``recurrent``
(StaticRNN), the tensor arrays (``write_to_array``, ``read_from_array``,
``lod_array_length``, ``is_empty``) and ``print``.

Counterpart of ``paddle_tpu/ops/control_flow.py`` (``write_to_array:115``,
``read_from_array:154``, ``lod_array_length:174``, ``is_empty:187``,
``while:225``, ``conditional_block:293``, ``recurrent:340``,
``print:440``).  Each op with a sub-block runs it through its
``LowerCtx`` (``ctx.run_sub_block``) against the live env of the block
that encloses it (``core/lowering.py`` ``StepRunner``).

The port runs eagerly, so every predicate and loop condition has a value:
it is read on the host (``LowerCtx.host_item``, counted as a host sync of
the step; on the card the read waits for the work queued before it).
A ``conditional_block`` whose sub-block has no ops runs nothing and reads
nothing.

Two forms, the reference's.  The reference traces a block into one XLA
computation: a value derived only from constants of the program is a
trace-time constant, one derived from a feed, a scope read or a random
draw is traced, and the two lower differently.  The port keeps the
reference's split so that its programs give the reference's results:
a value is *data-dependent* when it derives from a feed, a scope read or
a random draw (``StepRunner.dyn``: an op's outputs are data-dependent
when one of its inputs is, or when it draws), and constant otherwise.

* Constant condition: a ``while`` runs its body in the enclosing env
  while the condition holds; a ``conditional_block`` runs its body or
  not, and a var only the skipped body would create is absent after it.
  A ``while`` asks this of its condition alone, before each iteration; a
  ``conditional_block`` of its predicate and of every var its body reads
  from outside (the reference folds an op at trace time only when none
  of its inputs is traced).
  A tensor array is a Python list, grown by each write; a read past its
  end raises an IndexError.
* Data-dependent condition (the reference's ``lax.while_loop`` and
  ``lax.cond``): a ``while`` carries the names its body writes that
  exist before it, each list array among them becoming a bounded array
  (``BoundedTensorArray``: a zero-filled ``[FLAGS_tensor_array_max_len,
  ...]`` buffer and an int64 length on the device); the names the body
  writes and does not carry are gone after the loop.  A read of a
  bounded array past its length gives the buffer's zeros.  A write at a
  constant index checks the capacity and raises past it; a write at a
  data-dependent index is clamped into the buffer, as the reference's
  ``dynamic_update_index_in_dim`` clamps.  A ``conditional_block`` whose
  predicate is false gives each var only its body would create, where
  something after it reads it, as zeros of its shape (the reference's
  ``lax.cond`` default).  Everything such an op writes is data-dependent
  after it.
* A write at a data-dependent index makes a bounded array too, and
  ``lod_array_length`` is int64 in both forms.

Neither ``while`` nor ``conditional_block`` has a gradient (the
reference's ``grad_maker=None``): ``append_backward`` passes over them.
``recurrent`` runs its sub-block once a time step over the leading axis
of its step inputs; its gradient is the registry's auto grad op, the
forward replayed under ``torch.func.vjp`` through the sub-block's
lowerings.
"""

import numpy as np
import torch

from .. import flags
from ..core.lowering import run_op
from ..core.registry import register_op

_MAX_UNROLL = 10000


class BoundedTensorArray:
    """A tensor array as a ``[capacity, *elem]`` buffer and an int64 length
    on the device (the reference's form for a data-dependent loop)."""

    __slots__ = ("buffer", "length")

    def __init__(self, buffer, length):
        self.buffer = buffer
        self.length = length

    @property
    def capacity(self):
        return self.buffer.shape[0]


def _capacity():
    return int(flags.flag("FLAGS_tensor_array_max_len") or 256)


def to_bounded(arr, template=None):
    """A list array as a ``BoundedTensorArray``; ``template`` gives the
    element's shape and dtype when the list has none."""
    elems = [e for e in (arr or []) if e is not None]
    if template is None:
        if not elems:
            raise ValueError(
                "cannot infer tensor-array element shape from an empty "
                "array; write one element before the dynamic loop")
        template = elems[0]
    cap, n = _capacity(), len(arr or [])
    if n > cap:
        raise ValueError(
            "tensor array holds %d elements, over the dynamic-loop capacity "
            "%d (FLAGS_tensor_array_max_len)" % (n, cap))
    buf = torch.zeros((cap,) + tuple(template.shape), dtype=template.dtype,
                      device=template.device)
    for k, e in enumerate(arr or []):
        if e is not None:
            buf[k] = e.to(buf.dtype)
    return BoundedTensorArray(buf, torch.tensor(n, dtype=torch.int64,
                                                device=template.device))


def _clamped(i, n):
    """A [1] int64 index tensor clamped into [0, n - 1] (the reference's
    dynamic indexing clamps), read on the device."""
    return i.reshape(-1)[:1].long().clamp(0, n - 1)


# -- tensor arrays ------------------------------------------------------------


@register_op("write_to_array", inputs=("X", "I", "Array"), outputs=("Out",),
             optional_inputs=("Array",), grad_maker=None)
def write_to_array(ctx, x, i, array):
    """The array with ``x`` at index ``i``: a list grown with None up to it,
    or, for a bounded array or a data-dependent index, the bounded array
    written there."""
    dyn_i = ctx.is_dyn("I")
    if isinstance(array, BoundedTensorArray) or dyn_i:
        if not isinstance(array, BoundedTensorArray):
            array = to_bounded(array, template=x)
        if not dyn_i:
            ci = int(ctx.host_item(i))
            if ci >= array.capacity:
                raise ValueError(
                    "write_to_array index %d exceeds the dynamic-loop "
                    "capacity %d (FLAGS_tensor_array_max_len)"
                    % (ci, array.capacity))
        buf = array.buffer.index_copy(
            0, _clamped(i, array.capacity),
            x.to(array.buffer.dtype).unsqueeze(0))
        length = torch.maximum(array.length, i.reshape(()).long() + 1)
        return (BoundedTensorArray(buf, length),)
    idx = int(ctx.host_item(i))
    arr = list(array) if array is not None else []
    while len(arr) <= idx:
        arr.append(None)
    arr[idx] = x
    return (arr,)  # tuple-wrapped: a bare list would read as one per slot


@register_op("read_from_array", inputs=("X", "I"), outputs=("Out",),
             grad_maker=None)
def read_from_array(ctx, x, i):
    """Element ``i``: of a bounded array from its buffer (zeros past the
    length), of a list at a constant index by Python's indexing."""
    if isinstance(x, BoundedTensorArray):
        return x.buffer.index_select(0, _clamped(i, x.capacity))[0]
    if isinstance(x, list):
        if not ctx.is_dyn("I"):
            return x[int(ctx.host_item(i))]
        return torch.stack(x).index_select(0, _clamped(i, len(x)))[0]
    return x.index_select(0, _clamped(i, x.shape[0]))[0]


@register_op("lod_array_length", inputs=("X",), outputs=("Out",),
             grad_maker=None)
def lod_array_length(ctx, x):
    if isinstance(x, BoundedTensorArray):
        return x.length.to(torch.int64)
    n = len(x) if isinstance(x, list) else x.shape[0]
    return torch.tensor(n, dtype=torch.int64, device=ctx.device)


@register_op("is_empty", inputs=("X",), outputs=("Out",), grad_maker=None)
def is_empty(ctx, x):
    if isinstance(x, BoundedTensorArray):
        return x.length == 0
    n = len(x) if isinstance(x, list) else x.numel()
    return torch.tensor(n == 0, device=ctx.device)


# -- while ----------------------------------------------------------------------


def _reads_writes(block):
    """(names read before a write, names written) of a sub-block."""
    written, reads = set(), []
    for op in block.ops:
        for n in op.input_arg_names:
            if n and n not in written and n not in reads:
                reads.append(n)
        written.update(n for n in op.output_arg_names if n)
    return reads, written


@register_op("while", inputs=("X", "Condition"), outputs=("Out", "StepScopes"),
             attrs={"sub_block": -1, "is_test": False},
             duplicable_inputs=("X",), duplicable_outputs=("Out",),
             optional_inputs=("X",), grad_maker=None)
def while_op(ctx, xs, cond, sub_block=-1, is_test=False):
    """Run the body while the condition holds: in the enclosing env while
    the condition is constant, then, once it is data-dependent, with the
    reference's carries (the module docstring)."""
    env, runner = ctx.env, ctx.runner
    cond_name = ctx.op.input("Condition")[0]
    it = 0
    while not runner.is_dyn(cond_name):
        if not ctx.host_item(env[cond_name]):
            return None, None
        ctx.run_sub_block(env, it)
        it += 1
        if it > _MAX_UNROLL:
            raise RuntimeError("while ran past %d iterations" % _MAX_UNROLL)
    reads, writes = _reads_writes(ctx.op.block.program.block(sub_block))
    carried = [n for n in reads if n in writes and n in env]
    carried += [n for n in sorted(writes) if n in env and n not in carried]
    if cond_name not in carried:
        raise RuntimeError("while sub-block never updates its condition %r"
                           % cond_name)
    for n in carried:
        if isinstance(env[n], list):
            env[n] = to_bounded(env[n])
    before = set(env)
    while True:
        runner.dyn.update(carried)
        if not ctx.host_item(env[cond_name]):
            break
        ctx.run_sub_block(env, it)
        it += 1
    for n in writes:
        if n not in before:
            env.pop(n, None)
    return None, None


# -- conditional_block -----------------------------------------------------------


def _meta(v):
    if isinstance(v, torch.Tensor):
        return torch.empty_like(v, device="meta")
    if isinstance(v, list):
        return [None if e is None else _meta(e) for e in v]
    if isinstance(v, BoundedTensorArray):
        return BoundedTensorArray(_meta(v.buffer), _meta(v.length))
    return v


def _zeros_of(plan, op, env, names, device):
    """{name: zeros} of the vars ``names`` the sub-block of ``plan`` would
    create, shaped by a run of its lowerings on meta tensors (the
    reference's ``jax.eval_shape`` of the branch)."""
    local = {n: _meta(env[n]) for n in op.input("Input") if n in env}
    meta = torch.device("meta")
    for sub, opdef, attrs in plan.steps:
        run_op(sub, opdef, attrs, local, meta)
    return {n: torch.zeros(local[n].shape, dtype=local[n].dtype,
                           device=device) for n in names}


@register_op("conditional_block", inputs=("Cond", "Input"),
             outputs=("Out", "Scope"),
             attrs={"sub_block": -1, "is_scalar_condition": True},
             duplicable_inputs=("Cond", "Input"), duplicable_outputs=("Out",),
             optional_inputs=("Input",), grad_maker=None)
def conditional_block(ctx, conds, inputs, sub_block=-1,
                      is_scalar_condition=True):
    """Run the body in the enclosing env when the predicate holds; where
    the predicate or a var the body reads is data-dependent, a false one
    gives the body's new vars that are read after it as zeros."""
    plan = ctx.runner.sub_plan(ctx.op)
    if not plan.steps:
        return None, None
    cond = conds[0]
    pred = cond.reshape(()) if is_scalar_condition else cond.all()
    taken = bool(ctx.host_item(pred))
    env = ctx.env
    if not (ctx.is_dyn("Cond") or ctx.is_dyn("Input")):
        if taken:
            ctx.run_sub_block(env)
        return None, None
    writes = _reads_writes(plan.block)[1]
    if taken:
        ctx.run_sub_block(env)
    else:
        fresh = sorted(n for n in writes if n not in env and n in plan.keep)
        if fresh:
            env.update(_zeros_of(plan, ctx.op, env, fresh, ctx.device))
    ctx.runner.dyn.update(writes)
    return None, None


# -- recurrent (StaticRNN) --------------------------------------------------------


@register_op("recurrent", inputs=("StepInputs", "Initials", "Captured"),
             outputs=("StepOutputs", "FinalStates"),
             attrs={"sub_block": -1, "step_input_names": [],
                    "pre_state_names": [], "state_names": [],
                    "step_output_names": [], "captured_names": [],
                    "reverse": False},
             duplicable_inputs=("StepInputs", "Initials", "Captured"),
             duplicable_outputs=("StepOutputs", "FinalStates"),
             optional_inputs=("StepInputs", "Captured"))
def recurrent(ctx, step_inputs, initials, captured, sub_block=-1,
              step_input_names=(), pre_state_names=(), state_names=(),
              step_output_names=(), captured_names=(), reverse=False):
    """The sub-block once a time step over the step inputs' leading axis
    (last to first under ``reverse``): each step's env holds the captured
    vars, the states of the step before under ``pre_state_names`` and the
    step's slices; ``state_names`` carry on, ``step_output_names`` are
    stacked in time order.  Returns (stacked outputs, final states)."""
    step_inputs = list(step_inputs or [])
    if not step_inputs:
        raise ValueError("recurrent requires at least one step input")
    runner = ctx.runner
    plan = runner.sub_plan(ctx.op)
    T = step_inputs[0].shape[0]
    carry = list(initials)
    outs = [[] for _ in step_output_names]
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        env = dict(zip(captured_names, captured or []))
        env.update(zip(pre_state_names, carry))
        env.update((n, x[t]) for n, x in zip(step_input_names, step_inputs))
        runner.run(plan, env, ctx.path + (t,))
        carry = [env[n] for n in state_names]
        for acc, n in zip(outs, step_output_names):
            acc.append(env[n])
    if reverse:
        outs = [acc[::-1] for acc in outs]
    return [torch.stack(acc) for acc in outs], carry


def _recurrent_infer(op, block):
    """StepOutputs [T, *inner shape], FinalStates the inner states'."""
    sub = block.program.block(op.attr("sub_block"))
    T = None
    sin = op.input("StepInputs")
    if sin:
        v = block._find_var_recursive(sin[0])
        if v is not None and v.shape:
            T = v.shape[0]
    for outer, inner in zip(op.output("StepOutputs"),
                            op.attr("step_output_names") or []):
        iv, ov = sub._find_var_recursive(inner), \
            block._find_var_recursive(outer)
        if iv is not None and ov is not None and iv.shape is not None:
            ov.shape = (T,) + tuple(iv.shape) if T is not None else None
            ov.dtype = iv.dtype
    for outer, inner in zip(op.output("FinalStates"),
                            op.attr("state_names") or []):
        iv, ov = sub._find_var_recursive(inner), \
            block._find_var_recursive(outer)
        if iv is not None and ov is not None:
            ov.shape = iv.shape
            ov.dtype = iv.dtype


# -- print ------------------------------------------------------------------------


@register_op("print", inputs=("In",), outputs=("Out",),
             attrs={"message": "", "first_n": -1, "summarize": 20,
                    "print_tensor_name": True, "print_tensor_type": True,
                    "print_tensor_shape": True, "print_tensor_lod": False,
                    "print_phase": "BOTH"},
             grad_maker=None)
def print_op(ctx, x, message="", first_n=-1, summarize=20,
             print_tensor_name=True, print_tensor_shape=True, **_):
    """Passes ``x`` through and prints it on the host (a host sync): the
    message, the output's name, the shape and the first ``summarize``
    values, for the first ``first_n`` runs of the op (all with -1), in the
    reference's format."""
    if ctx.abstract:
        return x
    op = ctx.op
    count = getattr(op, "_print_count", 0) + 1
    op._print_count = count
    if first_n >= 0 and count > first_n:
        return x
    if ctx.runner is not None:
        ctx.runner.host_syncs += 1
    arr = x.detach().cpu().numpy()
    flat = arr.reshape(-1)
    parts = [message]
    name = op.output("Out")[0] if op is not None else ""
    if print_tensor_name and name:
        parts.append(name)
    if print_tensor_shape:
        parts.append(str(arr.shape))
    parts.append(np.array2string(flat[:summarize] if summarize >= 0
                                 else flat))
    print(" ".join(p for p in parts if p))
    return x


# -- shape inference: the ops that need the live env get none (the declared
# shapes stay, as in the reference); print copies its input's


def _no_infer(op, block):
    return None


def _copy_in_infer(op, block):
    xv = block._find_var_recursive(op.input("In")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if xv is not None and ov is not None:
        ov.shape = xv.shape
        if ov.dtype is None:
            ov.dtype = xv.dtype


for _fn in (write_to_array, read_from_array, while_op, conditional_block,
            lod_array_length, is_empty):
    _fn.opdef.infer_shape = _no_infer
print_op.opdef.infer_shape = _copy_in_infer
recurrent.opdef.infer_shape = _recurrent_infer
