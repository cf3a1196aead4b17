"""Op registry: each op type has a PyTorch lowering and shape inference.

Counterpart of ``paddle_tpu/core/registry.py`` (``register_op``,
``OpDef``, ``get_op_def``, ``GradOpDesc``, ``make_grad_ops:127``,
``_synthesize_grad_opdef:190``; default shape inference).  A lowering is
``lower(ctx, *input_slot_values, **attrs)`` over torch tensors, returning
one value per output slot (``None`` for a slot it leaves unset).

Gradients.  An op's grad maker is "auto" (the default: one
``<type>_grad`` op over the forward inputs, outputs and output grads),
None (no gradient) or a callable returning GradOpDescs.  The auto grad
op's lowering is synthesized: it replays the forward lowering under
``torch.func.vjp`` (``vjp_replay``, which an explicit grad lowering
calls with a forward of its own).  A lowering registered explicitly for
``<type>_grad`` (``register_grad_lowering``) keeps the synthesized op's
slots, so programs stay the reference's, and takes precedence: the port
registers one wherever the replay would recompute a matrix product or
reach a CUDA kernel, which ``torch.func`` cannot trace through ctypes.

Default shape inference.  The reference evaluates the lowering with a
symbolic batch dim (``jax.eval_shape``).  PyTorch has no symbolic sizes,
so the lowering runs twice on ``meta`` tensors (shapes and dtypes, no
data), once with every -1 input dim set to each of two stand-in sizes;
an output dim that differs between the runs follows the batch and
becomes -1.
"""

import torch

__all__ = ["OpDef", "GradOpDesc", "register_op", "register_grad_lowering",
           "vjp_replay", "get_op_def", "all_op_types", "lower_attrs",
           "wants_grad", "default_infer_shape"]

_OP_REGISTRY = {}

# two batch stand-ins for shape inference; any output dim that changes
# between them is batch-dependent
_STAND_INS = (5, 7)


class GradOpDesc:
    """One grad op to append: type, slot -> names maps and attrs."""

    def __init__(self, type, inputs, outputs, attrs=None):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = dict(attrs or {})


class OpDef:
    """Registered metadata and behaviour of one op type."""

    def __init__(self, type, inputs=(), outputs=(), attrs=None, lower=None,
                 infer_shape=None, grad_maker="auto", no_grad_inputs=(),
                 optional_inputs=(), duplicable_inputs=(),
                 duplicable_outputs=(), n_rng=0):
        self.type = type
        self.input_slots = tuple(inputs)
        self.output_slots = tuple(outputs)
        self.default_attrs = dict(attrs or {})
        self.lower = lower
        self.infer_shape = infer_shape
        # "auto" (the synthesized <type>_grad op), None (no gradient) or a
        # callable (op, no_grad_set) -> [GradOpDesc]
        self.grad_maker = grad_maker
        self.no_grad_inputs = frozenset(no_grad_inputs)
        self.optional_inputs = frozenset(optional_inputs)
        self.duplicable_inputs = frozenset(duplicable_inputs)
        self.duplicable_outputs = frozenset(duplicable_outputs)
        ins, outs = set(self.input_slots), set(self.output_slots)
        for label, members, universe in (
                ("no_grad_inputs", self.no_grad_inputs, ins),
                ("optional_inputs", self.optional_inputs, ins),
                ("duplicable_inputs", self.duplicable_inputs, ins),
                ("duplicable_outputs", self.duplicable_outputs, outs)):
            if members - universe:
                raise ValueError("op %r: %s %s are not declared slots (%s)"
                                 % (type, label, sorted(members - universe),
                                    sorted(universe)))
        self.n_rng = n_rng  # ops that draw random numbers
        # (attrs) -> whether a run draws; None: every run of an n_rng op
        self.rng_when = None

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
            default_infer_shape(self, op, block)

    def make_grad_ops(self, op, no_grad_set):
        """[GradOpDesc] of this forward op.  The auto maker's op reads the
        forward inputs, every output as ``Out@<slot>`` and its gradient as
        ``GRAD@<slot>``, and writes ``X@<slot>`` for each input that wants
        a gradient ("" holds the place of one that does not)."""
        if self.grad_maker is None:
            return []
        if callable(self.grad_maker):
            return self.grad_maker(op, no_grad_set)
        from ..framework import _grad_var_name

        inputs = {}
        for slot in self.input_slots:
            if op.input(slot):
                inputs[slot] = list(op.input(slot))
        for slot in self.output_slots:
            if op.output(slot):
                inputs["Out@" + slot] = list(op.output(slot))
                inputs["GRAD@" + slot] = [
                    _grad_var_name(n) if n else "" for n in op.output(slot)]
        outputs = {}
        block = op.block
        for slot in self.input_slots:
            if slot in self.no_grad_inputs:
                continue
            names = []
            for n in op.input(slot):
                v = block._find_var_recursive(n) if block is not None \
                    else None
                is_float = v is None or v.dtype is None \
                    or v.dtype.startswith(("float", "bfloat"))
                names.append("" if n in no_grad_set or not is_float
                             else _grad_var_name(n))
            if any(names):
                outputs["X@" + slot] = names
        if not outputs:
            return []
        return [GradOpDesc(self.type + "_grad", inputs, outputs,
                           dict(op.attrs))]


def _grad_slots(base):
    """Slots of the ``<type>_grad`` op the auto maker emits for ``base``:
    (inputs, outputs, optional, duplicable inputs, duplicable outputs)."""
    in_slots = list(base.input_slots)
    dup_in = set(base.duplicable_inputs)
    opt_in = set(base.optional_inputs)
    for s in base.output_slots:
        in_slots += ["Out@" + s, "GRAD@" + s]
        if s in base.duplicable_outputs:
            dup_in.update(("Out@" + s, "GRAD@" + s))
        opt_in.update(("Out@" + s, "GRAD@" + s))
    out_slots = ["X@" + s for s in base.input_slots]
    dup_out = {"X@" + s for s in base.input_slots
               if s in base.duplicable_inputs}
    return in_slots, out_slots, opt_in, dup_in, dup_out


def _grad_infer_shape(base):
    def infer(op, block):
        # each input grad has the shape and dtype of its forward input
        for s in base.input_slots:
            for fwd_name, gname in zip(op.input(s), op.output("X@" + s)):
                if not gname:
                    continue
                fv = block._find_var_recursive(fwd_name)
                gv = block._find_var_recursive(gname)
                if fv is not None and gv is not None:
                    gv.shape = fv.shape
                    if gv.dtype is None:
                        gv.dtype = fv.dtype

    return infer


def _is_float(x):
    if isinstance(x, (list, tuple)):
        return bool(x) and all(_is_float(t) for t in x)
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _wanted_grads(base, op, fwd_ins):
    """Per forward input: does the grad op write its gradient?"""
    want = []
    for s, x in zip(base.input_slots, fwd_ins):
        names = op.output("X@" + s) if op is not None else ["?"]
        want.append(bool(names) and any(names) and _is_float(x))
    return want


def vjp_replay(ctx, base, fwd_ins, fn, out_grads):
    """Input grads of ``fn(*fwd_ins)``, a replay of ``base``'s forward, by
    ``torch.func.vjp`` (which differentiates inside the executor's
    ``torch.no_grad``): over the float inputs whose grads the grad op
    writes (every float input outside a ``<type>_grad`` op), the output
    grads as cotangents (zeros for an output no consumer differentiated).
    -> one grad or None per forward input."""
    op = ctx.op if ctx.op is not None \
        and ctx.op.type == base.type + "_grad" else None
    diff_idx = [i for i, w in enumerate(_wanted_grads(base, op, fwd_ins))
                if w]
    if not diff_idx:
        return tuple(None for _ in fwd_ins)

    keep = []  # the float outputs, the ones vjp differentiates

    def fwd(*diff_vals):
        full = list(fwd_ins)
        for j, i in enumerate(diff_idx):
            full[i] = diff_vals[j]
        out = fn(*full)
        out = out if isinstance(out, tuple) else (out,)
        keep.extend(i for i, o in enumerate(out) if _is_float(o))
        return tuple(out[i] for i in keep)

    outs, vjp_fn = torch.func.vjp(fwd, *[fwd_ins[i] for i in diff_idx])
    cots = []
    for o, i in zip(outs, keep):
        g = out_grads[i]
        if isinstance(o, (list, tuple)):
            g = g or [None] * len(o)
            cots.append(type(o)(
                torch.zeros_like(oi) if gi is None else gi.to(oi.dtype)
                for oi, gi in zip(o, g)))
        else:
            cots.append(torch.zeros_like(o) if g is None else g.to(o.dtype))
    grads = vjp_fn(tuple(cots))
    result = [None] * len(fwd_ins)
    for j, i in enumerate(diff_idx):
        result[i] = grads[j]
    return tuple(result)


def _synthesize_grad_opdef(base):
    """The ``<type>_grad`` op of an auto maker: the forward lowering
    replayed under ``vjp_replay``."""
    in_slots, out_slots, opt_in, dup_in, dup_out = _grad_slots(base)
    n_in, n_out = len(base.input_slots), len(base.output_slots)

    def grad_lower(ctx, *args, **attrs):
        rest = args[n_in:]
        return vjp_replay(ctx, base, list(args[:n_in]),
                          lambda *full: base.lower(ctx, *full, **attrs),
                          [rest[2 * i + 1] for i in range(n_out)])

    return OpDef(base.type + "_grad", inputs=in_slots, outputs=out_slots,
                 lower=grad_lower, infer_shape=_grad_infer_shape(base),
                 grad_maker=None, optional_inputs=opt_in,
                 duplicable_inputs=dup_in, duplicable_outputs=dup_out)


def register_op(type, inputs=(), outputs=(), attrs=None, infer_shape=None,
                grad_maker="auto", no_grad_inputs=(), optional_inputs=(),
                duplicable_inputs=(), duplicable_outputs=(), n_rng=0):
    """Decorator registering a lowering function as op ``type``."""

    def deco(fn):
        if type in _OP_REGISTRY:
            raise ValueError("op %r registered twice" % type)
        opdef = OpDef(type, inputs=inputs, outputs=outputs, attrs=attrs,
                      lower=fn, infer_shape=infer_shape,
                      grad_maker=grad_maker, no_grad_inputs=no_grad_inputs,
                      optional_inputs=optional_inputs,
                      duplicable_inputs=duplicable_inputs,
                      duplicable_outputs=duplicable_outputs, n_rng=n_rng)
        _OP_REGISTRY[type] = opdef
        fn.opdef = opdef
        return fn

    return deco


def register_grad_lowering(base_type):
    """Decorator registering an explicit lowering for the auto maker's
    ``<base_type>_grad`` op, with the synthesized op's slots and shape
    inference.  It is called as the synthesized one is: the forward
    inputs, then (output, output grad) per forward output slot, and it
    returns one gradient (or None) per forward input."""

    def deco(fn):
        base = _OP_REGISTRY[base_type]
        if base.grad_maker != "auto":
            raise ValueError("op %r has no auto grad op" % base_type)
        name = base_type + "_grad"
        if name in _OP_REGISTRY:
            raise ValueError("op %r registered twice" % name)
        in_slots, out_slots, opt_in, dup_in, dup_out = _grad_slots(base)
        opdef = OpDef(name, inputs=in_slots, outputs=out_slots, lower=fn,
                      infer_shape=_grad_infer_shape(base), grad_maker=None,
                      optional_inputs=opt_in, duplicable_inputs=dup_in,
                      duplicable_outputs=dup_out)
        _OP_REGISTRY[name] = opdef
        fn.opdef = opdef
        return fn

    return deco


def get_op_def(type):
    _ensure_ops_loaded()
    if type not in _OP_REGISTRY and type.endswith("_grad"):
        base = _OP_REGISTRY.get(type[:-len("_grad")])
        if base is not None and base.grad_maker == "auto":
            _OP_REGISTRY[type] = _synthesize_grad_opdef(base)
    if type not in _OP_REGISTRY:
        raise ValueError("unknown op type %r (the port has %d: %s)"
                         % (type, len(_OP_REGISTRY),
                            ", ".join(sorted(_OP_REGISTRY))))
    return _OP_REGISTRY[type]


def wants_grad(ctx, slot):
    """Whether the grad op running in ``ctx`` writes ``X@<slot>``."""
    names = ctx.op.output("X@" + slot) if ctx.op is not None else ["?"]
    return bool(names) and any(names)


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
    from ..framework import OP_ROLE_KEY, OP_ROLE_VAR_KEY

    skip = (OP_ROLE_KEY, OP_ROLE_VAR_KEY, "op_namescope", "op_callstack",
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


def default_infer_shape(opdef, op, block):
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
        except (NotImplementedError, RuntimeError):
            # a path the port does not run yet, or stand-in sizes the op
            # cannot take (a flat [N] statistic beside a [-1, S, h] input):
            # the declared shapes stay, as the reference's do when its
            # symbolic evaluation fails
            return
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
