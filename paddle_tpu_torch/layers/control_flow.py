"""Control-flow layers: ``While``, ``Switch``, ``IfElse``, ``cond``,
``StaticRNN``, the tensor arrays, ``is_empty`` and ``Print``, with the
comparisons, ``logical_and`` and ``increment``, which the reference keeps
in its control-flow module.

Counterpart of ``paddle_tpu/layers/control_flow.py`` (``_sub_block:41``,
``_collect_captures:49``, ``increment:74``, ``create_array:87``,
``array_write:95``, ``array_read:106``, ``array_length:116``,
``is_empty:126``, ``Print:134``, ``_make_compare:145``, ``While:166``,
``Switch:190``, ``logical_not_layer:222``, ``_cond_block:240``,
``cond:254``, ``IfElse:291``, ``StaticRNN:353``).  Each builds a
sub-block (``Program._create_block``) and one op that runs it
(``ops/control_flow.py``); the op lists what the sub-block reads before
writing it in its ``X`` / ``Input`` slot and what it writes of the vars
outside it in ``Out`` (``_collect_captures``), so the enclosing block's
plan reads those from the scope and stores the persistable ones back.
The programs are the reference's.
"""

import contextlib

from ..layer_helper import LayerHelper
from ..utils import unique_name

__all__ = ["While", "Switch", "IfElse", "StaticRNN", "increment",
           "array_write", "array_read", "array_length", "create_array",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "cond", "is_empty", "Print"]


@contextlib.contextmanager
def _sub_block(program):
    block = program._create_block()
    try:
        yield block
    finally:
        program._rollback()


def _collect_captures(blk, parent, skip=()):
    """(captured, out_names) of a finished sub-block: the names it reads
    before writing them (but ``skip``), parameters made inside it
    included; and the names it writes that exist outside it."""
    writes, captured, skip = set(), [], set(skip)
    for op in blk.ops:
        for n in op.input_arg_names:
            if n and n not in writes and n not in skip and n not in captured:
                captured.append(n)
        writes.update(n for n in op.output_arg_names if n)
    out_names = sorted(n for n in writes
                       if parent.has_var_recursive(n) and not blk.has_var(n))
    return captured, out_names


def increment(x, value=1.0, in_place=True):
    """x + value, written into x itself unless ``in_place`` is False."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def create_array(dtype):
    """An empty tensor array of ``dtype``; its first write makes it."""
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name=unique_name.generate("array"), dtype=dtype, shape=None,
        type="LOD_TENSOR_ARRAY")


def array_write(x, i, array=None):
    """``array`` with x at index i (a [1] int tensor)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i], "Array": [array]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    """Element i of ``array``."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type="read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    """The number of elements of ``array``, an int64 scalar."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int64")
    out.shape = ()
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def is_empty(x, cond=None):
    """Whether ``x`` (a tensor or an array) has no elements."""
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def Print(input, first_n=-1, message=None, summarize=20, **kwargs):
    """``input`` passed through, printed on the host at each run."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or "", "first_n": first_n,
                            "summarize": summarize})
    return out


def _make_compare(op_type):
    def layer(x, y, cond=None, force_cpu=None):
        helper = LayerHelper(op_type)
        out = cond or helper.create_variable_for_type_inference(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


less_than = _make_compare("less_than")
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
equal = _make_compare("equal")
not_equal = _make_compare("not_equal")


def _logical_layer(op_type):
    def layer(x, y=None, out=None):
        helper = LayerHelper(op_type)
        out = out or helper.create_variable_for_type_inference(dtype="bool")
        inputs = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


# elementwise logic of bool variables (the reference's layers/__init__.py
# :86-110); logical_and also builds piecewise_decay's interval masks
logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not")


# the reference's name for the negation Switch, cond and IfElse build
logical_not_layer = logical_not


class While:
    """``with While(cond).block(): ...`` runs the body while ``cond``
    holds; the body must update ``cond``."""

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        with _sub_block(program) as blk:
            yield
        captured, out_names = _collect_captures(blk, parent)
        parent.append_op(
            type="while",
            inputs={"X": captured, "Condition": [self.cond_var]},
            outputs={"Out": out_names, "StepScopes": []},
            attrs={"sub_block": blk.idx, "is_test": self.is_test})


@contextlib.contextmanager
def _cond_block(helper, condition):
    program = helper.main_program
    parent = program.current_block()
    with _sub_block(program) as blk:
        yield
    captured, out_names = _collect_captures(blk, parent)
    parent.append_op(
        type="conditional_block",
        inputs={"Cond": [condition], "Input": captured},
        outputs={"Out": out_names, "Scope": []},
        attrs={"sub_block": blk.idx, "is_scalar_condition": True})


class Switch:
    """``with switch.case(cond): ...`` / ``with switch.default(): ...``: a
    chain of ``conditional_block`` ops, each case's predicate and-ed with
    the negation of every case before it."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        if not self.pre_not_conditions:
            cond = condition
            not_cond = logical_not_layer(condition)
        else:
            pre = self.pre_not_conditions[-1]
            cond = logical_and(pre, condition)
            not_cond = logical_and(pre, logical_not_layer(condition))
        self.pre_not_conditions.append(not_cond)
        with _cond_block(self.helper, cond):
            yield

    @contextlib.contextmanager
    def default(self):
        if not self.pre_not_conditions:
            raise ValueError("default() must follow at least one case()")
        with _cond_block(self.helper, self.pre_not_conditions[-1]):
            yield


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two ``conditional_block`` ops, on ``pred`` and on its negation, each
    assigning its function's outputs to shared output vars of the
    enclosing block; returns them (one var, or a list)."""
    helper = LayerHelper("cond", name=name)
    results = {}

    def run_branch(fn, condition):
        with _cond_block(helper, condition):
            out = fn()
            outs = out if isinstance(out, (list, tuple)) else [out]
            for i, o in enumerate(outs):
                if i not in results:
                    results[i] = helper.main_program.current_block() \
                        .parent_block.create_var(
                            name=unique_name.generate("cond_out"),
                            dtype=o.dtype, shape=o.shape)
                helper.append_op(type="assign", inputs={"X": [o]},
                                 outputs={"Out": [results[i]]})

    if true_fn is not None:
        run_branch(true_fn, pred)
    if false_fn is not None:
        run_branch(false_fn, logical_not_layer(pred))
    outs = [results[i] for i in sorted(results)]
    return outs[0] if len(outs) == 1 else outs


class IfElse:
    """Two ``conditional_block`` ops (on the predicate and on its
    negation) whose ``output`` calls assign into shared vars of the
    enclosing block, by position: a skipped branch leaves the other's
    values in place, so no merge op is needed."""

    OUT_IF_ELSE_BLOCKS = 2
    IN_IF_ELSE_TRUE_BLOCKS = 0
    IN_IF_ELSE_FALSE_BLOCKS = 1

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._slots = []
        self._counts = {True: 0, False: 0}
        self._branch = None

    @contextlib.contextmanager
    def true_block(self):
        self._branch = True
        with _cond_block(self.helper, self.cond):
            yield
        self._branch = None

    @contextlib.contextmanager
    def false_block(self):
        self._branch = False
        notp = logical_not_layer(self.cond)
        with _cond_block(self.helper, notp):
            yield
        self._branch = None

    def input(self, x):
        return x

    def output(self, *outs):
        if self._branch is None:
            raise ValueError("output() must be called inside a branch block")
        cur = self.helper.main_program.current_block()
        parent = cur.parent_block
        base = self._counts[self._branch]
        for k, o in enumerate(outs):
            i = base + k
            if i >= len(self._slots):
                self._slots.append(parent.create_var(
                    name=unique_name.generate("ifelse_out"), dtype=o.dtype,
                    shape=o.shape))
            cur.append_op(type="assign", inputs={"X": [o]},
                          outputs={"Out": [self._slots[i].name]})
        self._counts[self._branch] = base + len(outs)

    def __call__(self):
        if self._counts[True] != self._counts[False] and \
                0 not in (self._counts[True], self._counts[False]):
            raise ValueError("true/false branches produced different arity")
        return list(self._slots)


class StaticRNN:
    """A fixed-length RNN over the leading (time) axis, one ``recurrent``
    op::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [T, B, D] -> x_t: [B, D]
            h_prev = rnn.memory(init=h0)     # or shape + batch_ref
            h = some_layers(x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                          # [T, B, H]
    """

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_inputs = []      # (outer var, inner var)
        self.memories = {}        # inner pre-state name -> [init, new inner]
        self.step_outputs = []
        self._block = None
        self.outputs = []

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent = program.current_block()
        self.status = StaticRNN.IN_RNN_BLOCK
        with _sub_block(program) as blk:
            self._block = blk
            yield
        self.status = StaticRNN.AFTER_RNN_BLOCK
        self._complete()

    def _assert_in_rnn_block(self):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError("must be called inside rnn.step()")

    def step_input(self, x):
        self._assert_in_rnn_block()
        inner = self._block.create_var(
            name=unique_name.generate("rnn_step_in"), dtype=x.dtype,
            shape=tuple(x.shape[1:]) if x.shape else None)
        self.seq_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, dtype="float32"):
        self._assert_in_rnn_block()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory needs `init` or (`shape`+`batch_ref`)")
            from . import tensor as ltensor

            # the init is built in the parent block; a shape with its -1
            # batch dim or without it
            program = self.helper.main_program
            cur = program.current_block_idx
            program.current_block_idx = self._parent.idx
            try:
                full = list(shape) if shape and shape[0] == -1 \
                    else [-1] + list(shape)
                init = ltensor.fill_constant_batch_size_like(
                    input=batch_ref, shape=full, value=init_value,
                    dtype=dtype, input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=0)
            finally:
                program.current_block_idx = cur
        inner = self._block.create_var(
            name=unique_name.generate("rnn_mem"), dtype=init.dtype,
            shape=init.shape)
        self.memories[inner.name] = [init, None]
        return inner

    def update_memory(self, mem, var):
        self._assert_in_rnn_block()
        if mem.name not in self.memories:
            raise ValueError("%r is not a memory of this RNN" % mem.name)
        self.memories[mem.name][1] = var

    def step_output(self, o):
        self._assert_in_rnn_block()
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        blk, parent = self._block, self._parent
        for name, (_init, new) in self.memories.items():
            if new is None:
                raise ValueError("memory %r never updated" % name)
        special = {i.name for _, i in self.seq_inputs} | set(self.memories)
        captured, _ = _collect_captures(blk, parent, skip=special)
        outer_outs = [parent.create_var(
            name=unique_name.generate("rnn_out"), dtype=o.dtype, shape=None)
            for o in self.step_outputs]
        final_states = [parent.create_var(
            name=unique_name.generate("rnn_final"), dtype=new.dtype,
            shape=new.shape) for _init, new in self.memories.values()]
        parent.append_op(
            type="recurrent",
            inputs={"StepInputs": [x.name for x, _ in self.seq_inputs],
                    "Initials": [init.name for init, _new
                                 in self.memories.values()],
                    "Captured": captured},
            outputs={"StepOutputs": [v.name for v in outer_outs],
                     "FinalStates": [v.name for v in final_states]},
            attrs={"sub_block": blk.idx,
                   "step_input_names": [i.name for _, i in self.seq_inputs],
                   "pre_state_names": list(self.memories),
                   "state_names": [new.name for _init, new
                                   in self.memories.values()],
                   "step_output_names": [o.name for o in self.step_outputs],
                   "captured_names": captured,
                   "reverse": False})
        self.outputs = outer_outs

    def __call__(self, *args):
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs
