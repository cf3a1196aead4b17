"""Autodiff by program rewriting.

Counterpart of ``paddle_tpu/backward.py`` (``append_backward:288``,
``_collect_no_grad``, ``_propagate_no_grad``, ``_relevant_ops``,
``_dedup_grad_ops``): walk the block's ops in reverse, emit each op's
grad ops from the registry's grad makers, sum gradients that several
grad ops produce, and annotate the grad-producing ops with
``op_role_var`` so the optimizer can find {param, grad} pairs.  The
programs it builds equal the reference's op for op.  Left out for
later: ``gradients()`` and recompute segments (``checkpoints``).
"""

from .core.registry import GradOpDesc, get_op_def
from .framework import (GRAD_SUFFIX, OP_ROLE_KEY, OP_ROLE_VAR_KEY, OpRole,
                        _grad_var_name)
from .ops.common import dtype_enum

__all__ = ["append_backward"]


def _collect_no_grad(block, no_grad_set):
    ng = set(no_grad_set or ())
    ng.update(name for name, var in block.vars.items()
              if var.stop_gradient)
    return _propagate_no_grad(block, ng)


def _propagate_no_grad(block, ng):
    """Forward-close the no-grad set: a var computed only from no-grad
    inputs, or by an op with no gradient or no inputs at all, can never
    receive a gradient, so no grad chain is built below it (the attention
    mask's matmul/scale/unsqueeze2 in BERT)."""
    for op in block.ops:
        if op.attr(OP_ROLE_KEY) == OpRole.Optimize:
            continue
        opdef = get_op_def(op.type)
        outs = [n for n in op.output_arg_names if n]
        if not outs:
            continue
        if opdef.grad_maker is None:
            dead = True
        else:
            ins = [n for slot in opdef.input_slots
                   if slot not in opdef.no_grad_inputs
                   for n in op.input(slot) if n]
            dead = all(n in ng for n in ins)  # vacuous for zero-input ops
        if dead:
            # an in-place alias of a differentiable var stays as it is
            ng.update(n for n in outs if n not in op.input_arg_names)
    return ng


def _relevant_ops(block, loss_name, no_grad_set):
    """Reverse reachability from the loss: (indices of the ops whose
    outputs feed it, newest first; names a gradient flows through)."""
    grad_flow = {loss_name}
    relevant = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if op.attr(OP_ROLE_KEY) == OpRole.Optimize:
            continue
        if not any(n in grad_flow for n in op.output_arg_names if n):
            continue
        opdef = get_op_def(op.type)
        if opdef.grad_maker is None:
            continue
        relevant.append(idx)
        for slot in opdef.input_slots:
            if slot in opdef.no_grad_inputs:
                continue
            grad_flow.update(n for n in op.input(slot)
                             if n and n not in no_grad_set)
    return relevant, grad_flow


def _dedup_grad_ops(grad_op_descs):
    """A gradient several grad ops produce is renamed per producer
    (``<name>@RENAME@<i>``) and summed by a ``sum`` op right after its
    last producer."""
    producers = {}
    for gop in grad_op_descs:
        for names in gop.outputs.values():
            for n in names:
                if n:
                    producers[n] = producers.get(n, 0) + 1
    multi = {n for n, c in producers.items() if c > 1}
    if not multi:
        return grad_op_descs
    result = []
    seen = {n: 0 for n in multi}
    renames = {n: [] for n in multi}
    remaining = {n: producers[n] for n in multi}
    for gop in grad_op_descs:
        finished = []
        for slot, names in list(gop.outputs.items()):
            new_names = []
            for n in names:
                if n in multi:
                    rn = "%s@RENAME@%d" % (n, seen[n])
                    seen[n] += 1
                    renames[n].append(rn)
                    remaining[n] -= 1
                    if remaining[n] == 0:
                        finished.append(n)
                    new_names.append(rn)
                else:
                    new_names.append(n)
            gop.outputs[slot] = new_names
        result.append(gop)
        for n in finished:
            result.append(GradOpDesc("sum", {"X": list(renames[n])},
                                     {"Out": [n]},
                                     {OP_ROLE_KEY: OpRole.Backward}))
    return result


def _append_grad_op(block, gop):
    """Create the grad op's missing output vars (shaped as their forward
    var), then append it."""
    for names in gop.outputs.values():
        for n in names:
            if not n or block.has_var_recursive(n):
                continue
            base = n.split("@RENAME@")[0]
            src = block._find_var_recursive(base[:-len(GRAD_SUFFIX)]) \
                if base.endswith(GRAD_SUFFIX) else None
            if src is not None:
                block.create_var(name=n, shape=src.shape, dtype=src.dtype)
            else:
                block.create_var(name=n)
    attrs = dict(gop.attrs)
    attrs[OP_ROLE_KEY] = OpRole.Backward
    return block.append_op(type=gop.type, inputs=gop.inputs,
                           outputs=gop.outputs, attrs=attrs)


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append the grad ops of ``loss`` to its program; returns
    [(param, grad)] of the trainable parameters that get a gradient."""
    program = loss.block.program
    block = program.global_block()
    no_grad = _collect_no_grad(block, no_grad_set)

    with program._role_guard(OpRole.Backward):
        # d(loss)/d(loss) = 1
        loss_grad_name = _grad_var_name(loss.name)
        block.create_var(name=loss_grad_name, shape=loss.shape or (1,),
                         dtype=loss.dtype)
        block.append_op(
            type="fill_constant", outputs={"Out": [loss_grad_name]},
            attrs={"shape": list(loss.shape or (1,)), "value": 1.0,
                   "dtype": dtype_enum(loss.dtype or "float32"),
                   OP_ROLE_KEY: OpRole.Backward | OpRole.Loss})
        relevant, grad_flow = _relevant_ops(block, loss.name, no_grad)
        grad_op_descs = []
        for idx in relevant:
            op = block.ops[idx]
            ng = no_grad | {n for n in op.input_arg_names
                            if n and n not in grad_flow}
            grad_op_descs.extend(get_op_def(op.type).make_grad_ops(op, ng))
        for gop in _dedup_grad_ops(grad_op_descs):
            _append_grad_op(block, gop)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    params_and_grads = []
    for p in params:
        gname = _grad_var_name(p.name)
        if not block.has_var_recursive(gname):
            continue
        g = block.var(gname)
        if g.shape is None or g.shape != p.shape:
            g.shape = p.shape
        if g.dtype is None:
            g.dtype = p.dtype
        params_and_grads.append((p, g))

    # op_role_var on the grad-producing ops: [param, grad, ...]
    grad_names = {g.name: p.name for p, g in params_and_grads}
    for op in block.ops:
        if op.attr(OP_ROLE_KEY) is None \
                or not int(op.attr(OP_ROLE_KEY)) & OpRole.Backward:
            continue
        rv = list(op.attrs.get(OP_ROLE_VAR_KEY, []))
        for n in op.output_arg_names:
            if n in grad_names:
                rv.extend([grad_names[n], n])
        if rv:
            op.attrs[OP_ROLE_VAR_KEY] = rv
    return params_and_grads
