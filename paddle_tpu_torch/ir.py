"""Program-level IR passes.

Counterpart of ``paddle_tpu/ir.py`` (``Pass``, ``register_pass``,
``apply_pass``, ``_commit_replacements:352``, ``FuseOptimizerOpsPass:556``).
The slice ports the optimizer fusion the executor applies to every
training program; the inference passes (``delete_dropout_pass``,
``multihead_matmul_fuse_pass``, ...) are still to port.
"""

__all__ = ["Pass", "register_pass", "get_pass", "apply_pass",
           "FuseOptimizerOpsPass"]

_PASS_REGISTRY = {}


class Pass:
    """A program rewrite: override ``apply(program, scope)``.
    ``protected`` holds names a pass must keep produced (feed and fetch
    targets)."""

    name = None
    protected = frozenset()

    def apply(self, program, scope):
        raise NotImplementedError


def register_pass(name):
    def deco(cls):
        cls.name = name
        _PASS_REGISTRY[name] = cls
        return cls

    return deco


def get_pass(name):
    return _PASS_REGISTRY[name]()


def apply_pass(name, program, scope, protected=()):
    """Apply one registered pass in place; returns the program."""
    p = get_pass(name)
    p.protected = frozenset(protected)
    p.apply(program, scope)
    return program


def _commit_replacements(program, block, replaced):
    """Rewrite ``block.ops`` from {id(op): new op or None (delete)} and
    bump the program's version, which invalidates executor plans."""
    if not replaced:
        return
    block.ops = [replaced.get(id(op), op) for op in block.ops
                 if replaced.get(id(op), op) is not None]
    program._bump_version()


@register_pass("fuse_optimizer_ops_pass")
class FuseOptimizerOpsPass(Pass):
    """Coalesce per-parameter adam ops into one ``fused_adam`` op.

    Groups ops sharing their hyperparameter attrs, LearningRate var and
    param dtype; a group of at least MIN_GROUP becomes one fused op over
    duplicable slots, placed where its last member was.  A group is
    skipped when an op between its first and last member reads or writes
    any of its state, or writes the shared LearningRate, or when an adam
    op takes per-op beta tensors.  Diverged beta pows are safe: the fused
    op applies each member's own bias correction.  Only params of rank
    <= MAX_PARAM_RANK fuse (the reference's FLAGS_fuse_optimizer_max_rank
    default, which keeps its 4-D conv kernels apart); BERT's params are
    all 1-D or 2-D, so its whole set is one group."""

    MIN_GROUP = 4
    MAX_PARAM_RANK = 2
    _STATE_SLOTS = {"adam": ("Param", "Grad", "Moment1", "Moment2",
                             "Beta1Pow", "Beta2Pow")}
    _OUT_SLOTS = {"adam": ("ParamOut", "Moment1Out", "Moment2Out",
                           "Beta1PowOut", "Beta2PowOut")}
    _FUSED_ATTRS = {"adam": ("beta1", "beta2", "epsilon")}
    _META_ATTRS = frozenset({"op_role", "op_role_var", "op_namescope",
                             "op_callstack", "op_device"})

    def _groups(self, block):
        groups = {}
        for op in block.ops:
            if op.type not in self._STATE_SLOTS:
                continue
            if op.input("Beta1Tensor") or op.input("Beta2Tensor"):
                continue
            pv = block._find_var_recursive(op.input("Param")[0])
            attrs_key = tuple(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in sorted(op.attrs.items())
                if k not in self._META_ATTRS)
            key = (op.type, op.input("LearningRate")[0],
                   None if pv is None else pv.dtype, attrs_key)
            groups.setdefault(key, []).append(op)
        return groups

    def _low_rank(self, block, op):
        v = block._find_var_recursive(op.input("Param")[0])
        return v is not None and v.shape is not None \
            and len(v.shape) <= self.MAX_PARAM_RANK

    def apply(self, program, scope):
        from .framework import Operator

        block = program.global_block()
        pos = {id(op): i for i, op in enumerate(block.ops)}
        replaced = {}
        for (op_type, lr_name, _dt, _ak), ops in \
                self._groups(block).items():
            ops = [o for o in ops if self._low_rank(block, o)]
            if len(ops) < self.MIN_GROUP:
                continue
            slots = self._STATE_SLOTS[op_type]
            state = set()
            for o in ops:
                for s in slots:
                    state.update(o.input(s))
                state.update(o.output_arg_names)
            if state & self.protected:
                continue
            member = {id(o) for o in ops}
            lo = min(pos[id(o)] for o in ops)
            hi = max(pos[id(o)] for o in ops)
            hazard = any(
                (set(other.input_arg_names) | set(other.output_arg_names))
                & state or lr_name in other.output_arg_names
                for other in block.ops[lo:hi + 1]
                if id(other) not in member)
            if hazard:
                continue
            inputs = {s: [o.input(s)[0] for o in ops] for s in slots}
            inputs["LearningRate"] = [lr_name]
            outputs = {s: [o.output(s)[0] for o in ops]
                       for s in self._OUT_SLOTS[op_type]}
            attrs = {k: ops[0].attrs[k]
                     for k in self._FUSED_ATTRS[op_type] if k in ops[0].attrs}
            fused = Operator(block, type="fused_" + op_type, inputs=inputs,
                             outputs=outputs, attrs=attrs)
            last = max(ops, key=lambda o: pos[id(o)])
            for o in ops:
                replaced[id(o)] = fused if o is last else None
        _commit_replacements(program, block, replaced)
