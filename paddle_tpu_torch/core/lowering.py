"""Block plans: which names a block reads from the scope, which it writes
back, and how one op runs.

Counterpart of ``paddle_tpu/core/lowering.py`` (``LowerCtx``,
``analyze_block:88``, ``BlockPlan:126``, ``analyze_param_carry:181``,
``_gather_slot:273``, ``run_op:336``).  The reference traces a whole
block into one XLA computation; the port interprets the block op by op in
eager PyTorch, each op's lowering launching its kernels directly.

The param carry (``FLAGS_layout_match_params`` under the bf16 AMP
policy): ``analyze_param_carry`` picks the f32 weights whose only readers
are one product, its grad and its optimizer.  The executor puts a bf16
copy of each under the weight's name and the f32 master under
``<name>@MASTER``, which only an optimizer's ``Param`` slot reads
(``_gather``).

Sub-blocks (the reference's ``LowerCtx.env`` and ``run_sub_block``,
``paddle_tpu/core/lowering.py:42-55``).  A step runs under one
``StepRunner``: it runs a block's plan op by op against an env, and an op
with a sub-block (``while``, ``conditional_block``, ``recurrent``) gets
it through its ``LowerCtx`` with the live env of the block that encloses
it (``ctx.env``), so ``ctx.run_sub_block`` runs the sub-block against
that env in place.  Each sub-block is planned once per step plan
(``StepRunner.sub_plan``), a ``BlockPlan`` with its own ``release``
list, so its temporaries die inside it.  The runner also counts the
host reads of device values the control-flow ops make (a predicate, a
loop condition, a list array's index, a print: on the card each waits
for the work queued before it) and, where the program has control flow,
which names hold data-dependent values (``StepRunner.dyn``: see
``ops/control_flow.py`` for what that decides).

Seeds: op ``i`` of the global block at step ``s`` draws from
``op_seed(program_seed, s, i)``; op ``j`` of a sub-block draws from
``np.random.SeedSequence([program_seed, s, i, it, j])``, ``i`` the index
of the enclosing op in its block and ``it`` the loop's iteration (the time
step of a ``recurrent``, 0 for a ``conditional_block``), one more
(index, iteration) pair for each level of nesting (``path_seed``).
"""

import numpy as np
import torch

from .registry import get_op_def, lower_attrs

__all__ = ["LowerCtx", "BlockPlan", "StepRunner", "analyze_block",
           "analyze_param_carry", "draws", "op_seed", "path_seed", "run_op",
           "MASTER_SUFFIX"]


class LowerCtx:
    """Per-op context handed to lowerings: the device the op runs on, the
    op itself, and for an op that draws random numbers its integer seed
    (``op_seed``; ``None`` during shape inference and for an op whose
    draw is not active).

    Random ops take their randomness from that seed on the host: dropout
    derives the two key words of its Philox stream (``seed_words``), and
    ``uniform_random`` a ``torch.Generator`` (``generator``).  Keys made
    on the host are the same on every device, so a step on the card draws
    the masks its plain CPU run draws.

    ``carry`` (a step's param carry, or None): carried param name -> its
    bf16 copy.  An optimizer op that writes a carried param's new bf16
    copy itself (the fused kernels do, in the copy's own buffer on the
    card) stores it there and adds the name to ``carry_written``."""

    def __init__(self, device, op=None, seed=None, carry=None,
                 carry_written=None, runner=None, env=None, path=()):
        self.device = device
        self.op = op
        self.seed = seed
        self.carry = carry
        self.carry_written = carry_written
        # the step's StepRunner, the live env of the enclosing block and
        # the op's place in the step (its index, under each enclosing
        # op's (index, iteration)); None / () outside an executor step
        self.runner = runner
        self.env = env
        self.path = path

    def run_sub_block(self, env, iteration=0):
        """Run the op's sub-block against ``env`` in place; ``iteration``
        (the loop's count) enters the seeds of its random ops."""
        runner = self.runner
        runner.run(runner.sub_plan(self.op), env, self.path + (iteration,))

    def is_dyn(self, slot):
        """Whether the op's ``slot`` holds a data-dependent value (see
        ``ops/control_flow.py``): False outside a step that tracks it."""
        dyn = self.runner.dyn if self.runner is not None else None
        return dyn is not None and any(n in dyn for n in self.op.input(slot))

    def host_item(self, t):
        """A one-element tensor's value on the host, counted as a host
        sync of the step (on the card the read waits for the queued
        work)."""
        if self.runner is not None:
            self.runner.host_syncs += 1
        return t.reshape(-1)[0].item()

    def amp_bf16(self):
        """True when the op's program runs under the bf16 AMP policy
        (``contrib.mixed_precision.decorate`` sets ``_amp_bf16``)."""
        block = self.op.block if self.op is not None else None
        return bool(getattr(block.program if block is not None else None,
                            "_amp_bf16", False))

    @property
    def abstract(self):
        """True during shape inference (meta tensors, no data)."""
        return self.device.type == "meta"

    @property
    def generator(self):
        """A ``torch.Generator`` on the op's device seeded with the op's
        seed (None without one)."""
        if self.seed is None:
            return None
        return new_generator(self.device, self.seed)

    def seed_words(self):
        """The two u32 key words of the op's Philox stream: the low and
        high words of its seed; zeros during shape inference."""
        if self.abstract:
            return 0, 0
        if self.seed is None:
            raise RuntimeError(
                "op %s draws random numbers but was given no seed"
                % (self.op.type if self.op is not None else "?"))
        return self.seed & 0xFFFFFFFF, (self.seed >> 32) & 0xFFFFFFFF


def _runtime_ops(block):
    return [op for op in block.ops if op.type not in ("feed", "fetch")]


def analyze_block(block, feed_names):
    """Liveness: names the block must read from the scope (not fed, not
    produced by an earlier op, not a tensor array), and persistable names
    it writes."""
    feed = set(feed_names)
    written = set()
    external = []
    for op in _runtime_ops(block):
        for name in op.input_arg_names:
            # a gradient no op produced is an implicit zero for the grad
            # op that reads it, never a scope read
            if name and name not in feed and name not in written \
                    and name not in external and not _is_grad_name(name) \
                    and not _is_array(block, name):
                external.append(name)
        written.update(n for n in op.output_arg_names if n)
    persist_written = []
    for op in _runtime_ops(block):
        for name in op.output_arg_names:
            v = block._find_var_recursive(name) if name else None
            if v is not None and v.persistable and name not in feed \
                    and name not in persist_written:
                persist_written.append(name)
    return external, written, persist_written


class BlockPlan:
    """Execution plan of one block for one feed/fetch signature: the ops
    with their definitions and attrs resolved once, so a run only gathers,
    calls and scatters.  With ``allow_carry``, ``carry_names`` lists the
    params the step reads as bf16 copies (``analyze_param_carry``).
    ``keep`` adds names no release may drop (a sub-block's: what its
    enclosing op and the rest of the step read)."""

    def __init__(self, block, feed_names, fetch_names, allow_carry=False,
                 keep=()):
        self.block = block
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.external, _written, self.persist_written = analyze_block(
            block, feed_names)
        rw = set(self.persist_written)
        self.carry_names = analyze_param_carry(
            block, self.feed_names, self.fetch_names,
            [n for n in self.external if n not in rw],
            [n for n in self.external if n in rw]) if allow_carry else []
        ops = _runtime_ops(block)
        self.steps = [(op, get_op_def(op.type), lower_attrs(op.attrs))
                      for op in ops]
        # release[i]: intermediates dead after step i (last read there, or
        # never read), dropped so the device allocator can reuse them
        keep = set(self.fetch_names) | set(self.persist_written) \
            | set(self.external) | set(self.feed_names) | set(keep)
        self.keep = keep
        last = {}
        for i, op in enumerate(ops):
            for n in op.output_arg_names:
                last.setdefault(n, i)
            for n in op.input_arg_names:
                last[n] = i
        self.release = [[] for _ in ops]
        for n, i in last.items():
            if n and n not in keep:
                self.release[i].append(n)
        # per step, the names it reads and writes (the data-dependence
        # bookkeeping), and the plans of the sub-blocks under it
        self.io = [(tuple(n for n in op.input_arg_names if n),
                    tuple(n for n in op.output_arg_names if n))
                   for op in ops]
        self.sub_plans = {}
        # whether a step keeps StepRunner.dyn: some op of the program asks
        self.track_dyn = any(op.type in _DYN_OPS for blk in
                             block.program.blocks for op in blk.ops)


# forward op types whose lowerings take their weight operand in bf16 under
# the AMP policy: a carried param may be read by one of these and its grad
_CARRY_CONSUMERS = frozenset((
    "mul", "matmul", "matmul_v2", "conv2d", "depthwise_conv2d",
))

# optimizer op types: their "Param" slot reads the f32 master
_OPTIMIZER_TYPES = frozenset((
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "lars_momentum", "lamb", "ftrl", "dpsgd",
    "fused_sgd", "fused_momentum", "fused_adam",
))

# ops with sub-blocks read outer vars the scan below cannot see
_SUBBLOCK_OPS = frozenset((
    "while", "conditional_block", "recurrent", "py_func",
))

MASTER_SUFFIX = "@MASTER"


def analyze_param_carry(block, feed_names, fetch_names, ro_names, rw_names):
    """Names of the persistable f32 params a step may read as bf16 copies,
    the reference's rule: every reader is an optimizer's ``Param`` slot
    (it reads the master), or one forward op of ``_CARRY_CONSUMERS`` plus
    at most one of its grad ops; the only writer, if any, is that
    optimizer's ParamOut.  Feeds, fetches, programs with sub-block ops and
    programs not under the AMP policy carry nothing.  One forward reader
    keeps gradient accumulation out: two bf16 branch grads would be summed
    in bf16 where the per-step cast sums their f32 casts."""
    if any(op.type in _SUBBLOCK_OPS for op in block.ops):
        return []
    if not getattr(block.program, "_amp_bf16", False):
        return []
    skip = set(feed_names) | set(fetch_names)
    readers, writers = {}, {}
    for op in _runtime_ops(block):
        for n in op.input_arg_names:
            if n:
                readers.setdefault(n, []).append(op)
        for n in op.output_arg_names:
            if n:
                writers.setdefault(n, []).append(op)
    out = []
    for n in list(ro_names) + list(rw_names):
        v = block._find_var_recursive(n)
        if n in skip or v is None or not v.persistable or v.shape is None \
                or v.dtype != "float32":
            continue
        n_fwd = n_grad = 0
        ok = True
        for op in readers.get(n, ()):
            if op.type in _OPTIMIZER_TYPES and n in op.input("Param"):
                continue
            if op.type in _CARRY_CONSUMERS:
                n_fwd += 1
            elif op.type.endswith("_grad") \
                    and op.type[:-5] in _CARRY_CONSUMERS:
                n_grad += 1
            else:
                ok = False
                break
        ok = ok and n_fwd == 1 and n_grad <= 1 and all(
            op.type in _OPTIMIZER_TYPES and n in op.output("ParamOut")
            for op in writers.get(n, ()))
        if ok:
            out.append(n)
    return out


def _is_array(block, name):
    """A tensor array lives in the step's env only (a Python list that
    its first ``write_to_array`` makes), never in the scope."""
    v = block._find_var_recursive(name)
    return v is not None and v.type == "LOD_TENSOR_ARRAY"


def _is_grad_name(name):
    return name.endswith("@GRAD") or "@GRAD@" in name


def _gather(opdef, op, slot, env):
    names = op.input(slot)
    optional = slot in opdef.optional_inputs or slot.startswith(
        ("GRAD@", "Out@"))
    # an optimizer's Param slot reads a carried param's f32 master; only
    # optimizer ops have a Param slot
    master = slot == "Param"
    vals = []
    for n in names:
        if master and n + MASTER_SUFFIX in env:
            vals.append(env[n + MASTER_SUFFIX])
        elif n in env:
            vals.append(env[n])
        elif not n or optional or _is_grad_name(n):
            vals.append(None)
        else:
            raise KeyError("op %s input %s=%r is not initialized (not fed, "
                           "not in scope, not produced by a prior op)"
                           % (op.type, slot, n))
    if slot in opdef.duplicable_inputs:
        return vals
    return vals[0] if vals else None


def op_seed(program_seed, step, index):
    """Seed of op ``index`` at executor step ``step``: a deterministic
    function of the three, independent across ops (63 bits)."""
    return path_seed(program_seed, step, (index,))


def path_seed(program_seed, step, path):
    """Seed of the op at ``path`` (its index in the global block, or the
    enclosing op's index, the iteration and its own index in a sub-block,
    and so on down) at executor step ``step`` (63 bits)."""
    return int(np.random.SeedSequence(
        [program_seed & 0xFFFFFFFF, step & 0xFFFFFFFF] + list(path)
    ).generate_state(1, np.uint64)[0] >> 1)


def draws(opdef, attrs):
    """Whether a run of the op draws random numbers: it declares a draw
    (``n_rng``) and, where it has one, its ``rng_when(attrs)`` holds (the
    dropout ops draw only while their dropout is active)."""
    return bool(opdef.n_rng) and (opdef.rng_when is None
                                  or bool(opdef.rng_when(attrs)))


def run_op(op, opdef, attrs, env, device, seed=None, carry=None,
           carry_written=None, runner=None, path=()):
    """Run one op: gather its inputs from ``env``, call the lowering,
    scatter its outputs back."""
    args = [_gather(opdef, op, s, env) for s in opdef.input_slots]
    out = opdef.lower(LowerCtx(device, op, seed, carry, carry_written,
                               runner, env, path),
                      *args, **attrs)
    if len(opdef.output_slots) == 1 and not isinstance(out, tuple):
        out = (out,)
    for slot, val in zip(opdef.output_slots, out):
        names = op.output(slot)
        items = val if slot in opdef.duplicable_outputs else [val]
        for n, v in zip(names, items or ()):
            if n and v is not None:
                env[n] = v


# ops that run a sub-block against the env of the block enclosing them and
# write that env themselves: the data dependence of what they write is
# theirs to set
_ENV_OPS = frozenset(("while", "conditional_block"))

# op types whose lowerings ask whether a value is data-dependent
_DYN_OPS = frozenset(("while", "conditional_block", "write_to_array",
                      "read_from_array"))


def _outside_reads(program, idx):
    """Names read by the ops of every block of ``program`` but ``idx``."""
    return {n for blk in program.blocks if blk.idx != idx
            for op in blk.ops for n in op.input_arg_names if n}


class StepRunner:
    """One executor step: runs block plans op by op against an env.

    ``dyn`` (None where the program has no op that asks): the names of
    the env holding data-dependent values.  The feeds and the scope's
    values start it; an op's outputs join it when an input is in it or
    the op draws random numbers, and leave it otherwise; ``while`` and
    ``conditional_block`` set their writes' status themselves.
    ``host_syncs`` counts the host reads of device values the lowerings
    make through ``LowerCtx.host_item``.  ``run_op`` is the function each
    op runs through (the profilers swap the executor's)."""

    def __init__(self, plan, device, seed, step, carry=None,
                 carry_written=None, dyn=None, run_op=run_op):
        self.root = plan
        self.device = device
        self.seed = seed
        self.step = step
        self.carry = carry
        self.carry_written = carry_written
        self.dyn = dyn
        self.run_op = run_op
        self.host_syncs = 0

    def run(self, plan, env, path=()):
        """Run ``plan``'s ops against ``env``; ``path`` is the place of
        its block in the step (() for the global block)."""
        dyn = self.dyn
        for i, (op, opdef, attrs) in enumerate(plan.steps):
            p = path + (i,)
            seed = path_seed(self.seed, self.step, p) \
                if draws(opdef, attrs) else None
            mark = None
            if dyn is not None and op.type not in _ENV_OPS:
                ins, outs = plan.io[i]
                mark = seed is not None or any(n in dyn for n in ins)
            self.run_op(op, opdef, attrs, env, self.device, seed, self.carry,
                        self.carry_written, self, p)
            if mark is not None:
                if mark:
                    dyn.update(outs)
                else:
                    dyn.difference_update(outs)
            for n in plan.release[i]:
                env.pop(n, None)

    def is_dyn(self, name):
        return self.dyn is not None and name in self.dyn

    def sub_plan(self, op):
        """The plan of ``op``'s sub-block, made at its first run under
        this step plan.  Its releases keep what the enclosing op reads and
        writes, the names its attrs list (a ``recurrent``'s states and
        outputs), the step's fetches and whatever another block reads."""
        idx = op.attr("sub_block")
        plan = self.root.sub_plans.get(idx)
        if plan is None:
            program = op.block.program
            keep = set(op.input_arg_names) | set(op.output_arg_names) \
                | set(self.root.fetch_names) | _outside_reads(program, idx)
            for k, v in op.attrs.items():
                if k.endswith("_names") and isinstance(v, list):
                    keep.update(v)
            plan = BlockPlan(program.block(idx), (), (), keep=keep)
            self.root.sub_plans[idx] = plan
        return plan


def new_generator(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
