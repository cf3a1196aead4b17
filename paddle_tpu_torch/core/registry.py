"""Op registry: each op type has a PyTorch lowering and shape inference.

Counterpart of ``paddle_tpu/core/registry.py`` (``register_op``,
``OpDef``, ``get_op_def``; default shape inference).  A lowering is
``lower(ctx, *input_slot_values, **attrs)`` over torch tensors, returning
one value per output slot (``None`` for a slot it leaves unset).  The
slice is inference only: no grad-op makers.

Default shape inference.  The reference evaluates the lowering with a
symbolic batch dim (``jax.eval_shape``).  PyTorch has no symbolic sizes,
so the lowering runs twice on ``meta`` tensors (shapes and dtypes, no
data), once with every -1 input dim set to each of two stand-in sizes;
an output dim that differs between the runs follows the batch and
becomes -1.
"""

import torch

__all__ = ["OpDef", "register_op", "get_op_def", "all_op_types",
           "lower_attrs"]

_OP_REGISTRY = {}

# two batch stand-ins for shape inference; any output dim that changes
# between them is batch-dependent
_STAND_INS = (5, 7)


class OpDef:
    """Registered metadata and behaviour of one op type."""

    def __init__(self, type, inputs=(), outputs=(), attrs=None, lower=None,
                 infer_shape=None, optional_inputs=(), duplicable_inputs=(),
                 duplicable_outputs=(), n_rng=0):
        self.type = type
        self.input_slots = tuple(inputs)
        self.output_slots = tuple(outputs)
        self.default_attrs = dict(attrs or {})
        self.lower = lower
        self.infer_shape = infer_shape
        self.optional_inputs = frozenset(optional_inputs)
        self.duplicable_inputs = frozenset(duplicable_inputs)
        self.duplicable_outputs = frozenset(duplicable_outputs)
        ins, outs = set(self.input_slots), set(self.output_slots)
        for label, members, universe in (
                ("optional_inputs", self.optional_inputs, ins),
                ("duplicable_inputs", self.duplicable_inputs, ins),
                ("duplicable_outputs", self.duplicable_outputs, outs)):
            if members - universe:
                raise ValueError("op %r: %s %s are not declared slots (%s)"
                                 % (type, label, sorted(members - universe),
                                    sorted(universe)))
        self.n_rng = n_rng  # ops that draw random numbers

    def validate(self, op):
        for slot in op.inputs:
            if slot not in self.input_slots:
                raise ValueError("op %s has no input slot %r (has %s)"
                                 % (self.type, slot, self.input_slots))
        for slot in op.outputs:
            if slot not in self.output_slots:
                raise ValueError("op %s has no output slot %r (has %s)"
                                 % (self.type, slot, self.output_slots))
        for k, v in self.default_attrs.items():
            op.attrs.setdefault(k, v)

    def run_infer_shape(self, op, block):
        if self.infer_shape is not None:
            self.infer_shape(op, block)
        elif self.lower is not None:
            _default_infer_shape(self, op, block)


def register_op(type, inputs=(), outputs=(), attrs=None, infer_shape=None,
                optional_inputs=(), duplicable_inputs=(),
                duplicable_outputs=(), n_rng=0):
    """Decorator registering a lowering function as op ``type``."""

    def deco(fn):
        if type in _OP_REGISTRY:
            raise ValueError("op %r registered twice" % type)
        opdef = OpDef(type, inputs=inputs, outputs=outputs, attrs=attrs,
                      lower=fn, infer_shape=infer_shape,
                      optional_inputs=optional_inputs,
                      duplicable_inputs=duplicable_inputs,
                      duplicable_outputs=duplicable_outputs, n_rng=n_rng)
        _OP_REGISTRY[type] = opdef
        fn.opdef = opdef
        return fn

    return deco


def get_op_def(type):
    _ensure_ops_loaded()
    if type not in _OP_REGISTRY:
        raise ValueError("unknown op type %r (the port has %d: %s)"
                         % (type, len(_OP_REGISTRY),
                            ", ".join(sorted(_OP_REGISTRY))))
    return _OP_REGISTRY[type]


def all_op_types():
    _ensure_ops_loaded()
    return sorted(_OP_REGISTRY)


_ops_loaded = False


def _ensure_ops_loaded():
    global _ops_loaded
    if not _ops_loaded:
        _ops_loaded = True
        from .. import ops  # noqa: F401  (registers every lowering)


def lower_attrs(attrs):
    """Attrs a lowering receives: the framework's own are dropped."""
    from ..framework import OP_ROLE_KEY

    skip = (OP_ROLE_KEY, "op_role_var", "op_namescope", "op_callstack",
            "op_device", "with_quant_attr")
    return {k: v for k, v in attrs.items() if k not in skip}


def _meta_inputs(opdef, op, block, batch):
    """Meta tensors for every input slot with -1 dims set to ``batch``;
    None when some input's shape or dtype is unknown."""
    from ..framework import dtype_to_torch

    args = []
    for slot in opdef.input_slots:
        names = op.input(slot)
        if not names:
            args.append([] if slot in opdef.duplicable_inputs else None)
            continue
        vals = []
        for n in names:
            v = block.var(n)
            if v.shape is None or v.dtype is None:
                return None
            shape = tuple(batch if d == -1 else d for d in v.shape)
            vals.append(torch.empty(shape, dtype=dtype_to_torch(v.dtype),
                                    device="meta"))
        args.append(vals if slot in opdef.duplicable_inputs else vals[0])
    return args


def _default_infer_shape(opdef, op, block):
    from ..framework import torch_dtype_name
    from .lowering import LowerCtx

    runs = []
    for batch in _STAND_INS:
        args = _meta_inputs(opdef, op, block, batch)
        if args is None:
            return  # cannot infer: declared shapes stay
        ctx = LowerCtx(device=torch.device("meta"), op=op)
        try:
            out = opdef.lower(ctx, *args, **lower_attrs(op.attrs))
        except NotImplementedError:
            return  # a path the port does not run yet: shapes stay
        if len(opdef.output_slots) == 1 and not isinstance(out, tuple):
            out = (out,)
        runs.append(out)
    for slot, a, b in zip(opdef.output_slots, *runs):
        names = op.output(slot)
        if not names or a is None:
            continue
        items_a = a if isinstance(a, list) else [a]
        items_b = b if isinstance(b, list) else [b]
        for n, ta, tb in zip(names, items_a, items_b):
            if ta is None:
                continue
            v = block.var(n)
            v.shape = tuple(da if da == db else -1
                            for da, db in zip(ta.shape, tb.shape))
            if v.dtype is None:
                v.dtype = torch_dtype_name(ta.dtype)
