"""Static Program verifier: checks a Program's IR before it runs.

Counterpart of ``paddle_tpu/core/analysis.py``, its single-program rule
families (``:360-615``): a malformed program (a dangling input, an op the
registry lacks, a declared dtype or shape the op contradicts) is reported
as structured diagnostics (severity, rule id, op index, var names, a
suggested fix) instead of an error deep inside a step.

Rule families
-------------
well-formedness   WF001 use-before-def / dangling input
                  WF002 unknown op type
                  WF003 unused op output                        (info)
                  WF004 op unreachable from the fetch targets   (warning)
                  WF005 undeclared input/output slot
type/shape flow   TS001 dtype mismatch (declared vs re-inferred)
                  TS002 shape contradiction (declared vs re-inferred)
                  TS003 grad var inconsistent with its forward var

Not here: the reference's DA001-DA003 (JAX buffer donation, which the
port's eager executor has no counterpart of), DL001-DL006 and the world
checks (collectives, ZeRO-1, parameter servers), which come with the
multi-card work.

Gating: ``FLAGS_static_check`` = ``off`` | ``warn`` (default) | ``error``.
``warn`` warns with a ``ProgramVerifyWarning`` and counts each flagged
diagnostic into the ``static_check_warnings`` telemetry counter; ``error``
raises a ``ProgramVerificationError`` with the report.  The Executor calls
``check_before_compile`` on a plan miss only, memoized per program
signature, so a steady step never pays for it.
"""

import time
import warnings

__all__ = [
    "Diagnostic", "VerifyReport", "ProgramVerifyWarning",
    "ProgramVerificationError", "RULES", "verify_program",
    "check_before_compile", "checked_reports",
]

ERROR = "error"
WARNING = "warning"
INFO = "info"

RULES = {
    "WF001": "input read before any definition (dangling input)",
    "WF002": "unknown op type (no registry entry)",
    "WF003": "op output produced but never consumed",
    "WF004": "op cannot reach any fetch target or persistable state",
    "WF005": "input/output slot not declared by the op's registry entry",
    "TS001": "declared dtype disagrees with re-inferred dtype",
    "TS002": "declared shape contradicts re-inferred shape",
    "TS003": "grad var shape/dtype disagrees with its forward var",
}


class ProgramVerifyWarning(UserWarning):
    """Category of warn-mode reports (filterable on its own)."""


class Diagnostic:
    """One finding: severity, rule id, location, vars, fix."""

    __slots__ = ("severity", "rule", "message", "block_idx", "op_idx",
                 "var_names", "suggestion", "block_path")

    def __init__(self, severity, rule, message, block_idx=None, op_idx=None,
                 var_names=(), suggestion=None, block_path=None):
        self.severity = severity
        self.rule = rule
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.var_names = tuple(var_names)
        self.suggestion = suggestion
        # the control-flow chain enclosing block_idx ("" at top level)
        self.block_path = block_path

    def location(self):
        if self.op_idx is None:
            return "program"
        where = "block %s op %s" % (
            0 if self.block_idx is None else self.block_idx, self.op_idx)
        if self.block_path:
            where += " in %s" % self.block_path
        return where

    def format(self):
        line = "%s %s [%s]: %s" % (self.rule, self.severity.upper(),
                                   self.location(), self.message)
        if self.suggestion:
            line += "\n    fix: %s" % self.suggestion
        return line

    def __repr__(self):
        return "Diagnostic(%s, %s, %s)" % (self.rule, self.severity,
                                           self.location())


class VerifyReport:
    """Ordered diagnostics with severity views and a readable render."""

    def __init__(self, diagnostics=(), label="program"):
        self.diagnostics = list(diagnostics)
        self.label = label
        # milliseconds the verification took (check_before_compile sets it)
        self.ms = None

    def add(self, *args, **kwargs):
        self.diagnostics.append(Diagnostic(*args, **kwargs))

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def infos(self):
        return [d for d in self.diagnostics if d.severity == INFO]

    def by_rule(self, rule):
        return [d for d in self.diagnostics if d.rule == rule]

    @property
    def ok(self):
        """No errors and no warnings (infos are advisory)."""
        return not self.errors and not self.warnings

    def format(self, max_items=50, include_info=True):
        shown = [d for d in self.diagnostics
                 if include_info or d.severity != INFO]
        lines = ["static check of %s: %d error(s), %d warning(s), %d info"
                 % (self.label, len(self.errors), len(self.warnings),
                    len(self.infos))]
        for d in shown[:max_items]:
            lines.append("  " + d.format().replace("\n", "\n  "))
        if len(shown) > max_items:
            lines.append("  ... %d more" % (len(shown) - max_items))
        return "\n".join(lines)

    def __repr__(self):
        return "<VerifyReport %s: %dE/%dW/%dI>" % (
            self.label, len(self.errors), len(self.warnings),
            len(self.infos))


class ProgramVerificationError(RuntimeError):
    """Raised under ``FLAGS_static_check=error``: the whole report."""

    def __init__(self, report):
        self.report = report
        super().__init__(report.format())


# -- shared helpers -----------------------------------------------------------

# legacy plumbing the executor never runs
_PLUMBING = ("feed", "fetch")

# ops with effects beyond their declared outputs: always live for WF004
_SIDE_EFFECT_OPS = frozenset((
    "while", "conditional_block", "recurrent", "py_func",
    "send", "recv", "send_barrier", "fetch_barrier", "prefetch",
    "listen_and_serv", "save", "save_combine", "load", "load_combine",
    "print", "assert", "c_sync_calc_stream", "c_sync_comm_stream",
    "c_gen_nccl_id", "c_comm_init", "c_wait_comm", "c_wait_compute",
))

# the reference registry's stateful op types
_STATEFUL_OPS = frozenset((
    "checkpoint_notify", "conditional_block", "conditional_block_infer",
    "delete_var", "fetch_barrier", "load", "load_combine", "prefetch",
    "recv", "save", "save_combine", "send", "send_barrier", "while",
    "write_to_array",
))

_GRAD_SUFFIX = "@GRAD"


def _is_gradish(name):
    return name.endswith(_GRAD_SUFFIX) or (_GRAD_SUFFIX + "@") in name


def _runtime_ops(block):
    """(op_idx, op) pairs but the plumbing; the indices are positions in
    ``block.ops``."""
    return [(i, op) for i, op in enumerate(block.ops)
            if op.type not in _PLUMBING]


def _block_paths(program):
    """{block idx: its enclosing control-flow chain}, e.g.
    ``"while@block0.op3 > conditional_block@block1.op2"``; "" for the
    global block."""
    parent_edge = {}
    for blk in program.blocks:
        for op_idx, op in enumerate(blk.ops):
            sub = op.attr("sub_block")
            if sub is None:
                continue
            parent_edge[int(getattr(sub, "idx", sub))] = (op.type, blk.idx,
                                                          op_idx)
    paths = {}
    for blk in program.blocks:
        segs, idx, seen = [], blk.idx, set()
        while idx in parent_edge and idx not in seen:
            seen.add(idx)
            op_type, pidx, oidx = parent_edge[idx]
            segs.append("%s@block%d.op%d" % (op_type, pidx, oidx))
            idx = pidx
        paths[blk.idx] = " > ".join(reversed(segs))
    return paths


def _opdef_or_none(op_type):
    from .registry import get_op_def

    try:
        return get_op_def(op_type)
    except Exception:
        return None


def _shapes_conflict(declared, inferred):
    """Two shapes that cannot describe one tensor: another rank, or a dim
    static in both that differs (-1 matches anything)."""
    if declared is None or inferred is None:
        return False
    if len(declared) != len(inferred):
        return True
    return any(d >= 0 and i >= 0 and d != i
               for d, i in zip(declared, inferred))


def _canon_dtype(dtype):
    """64-bit dtypes read as their 32-bit kin, as the reference compares
    them (JAX without x64 runs the IR's int64 as int32), so a program the
    reference passes passes here."""
    if dtype is None:
        return None
    return {"int64": "int32", "uint64": "uint32",
            "float64": "float32"}.get(dtype, dtype)


def _dtype_kind(dtype):
    if dtype is None:
        return None
    if dtype.startswith(("float", "bfloat")):
        return "float"
    if dtype == "bool":
        return "bool"
    return "int"


# -- family 1: well-formedness ------------------------------------------------


def _ancestor_names(block):
    names = set()
    blk = block.parent_block
    while blk is not None:
        names.update(blk.vars)
        blk = blk.parent_block
    return names


def _check_wellformed(program, feed_names, fetch_names, scope_names, rep,
                      paths):
    feed = set(feed_names)
    fetch = set(fetch_names)
    scope = set(scope_names or ())

    # reads across every block: a sub-block's ops read outer names without
    # appearing in the outer block's op list
    global_reads = set()
    for blk in program.blocks:
        for _, op in _runtime_ops(blk):
            global_reads.update(n for n in op.input_arg_names if n)

    for blk in program.blocks:
        path = paths.get(blk.idx)
        defined = feed | scope | _ancestor_names(blk)
        ops = _runtime_ops(blk)
        for op_idx, op in ops:
            opdef = _opdef_or_none(op.type)
            if opdef is None:
                rep.add(ERROR, "WF002", "op %r is not registered" % op.type,
                        blk.idx, op_idx,
                        suggestion="register it via core.registry."
                        "register_op or remove the op", block_path=path)
            else:
                for s in op.inputs:
                    if s not in opdef.input_slots:
                        rep.add(ERROR, "WF005",
                                "op %s has no input slot %r (declares %s)"
                                % (op.type, s, list(opdef.input_slots)),
                                blk.idx, op_idx, op.input(s),
                                block_path=path)
                for s in op.outputs:
                    if s not in opdef.output_slots:
                        rep.add(ERROR, "WF005",
                                "op %s has no output slot %r (declares %s)"
                                % (op.type, s, list(opdef.output_slots)),
                                blk.idx, op_idx, op.output(s),
                                block_path=path)

            optional = set()
            if opdef is not None:
                optional = {s for s in op.inputs
                            if s in opdef.optional_inputs
                            or s.startswith(("GRAD@", "Out@"))}
            for slot, names in op.inputs.items():
                for n in names:
                    if not n or n in defined or _is_gradish(n) \
                            or slot in optional:
                        continue
                    v = blk._find_var_recursive(n)
                    if v is None:
                        rep.add(ERROR, "WF001",
                                "op %s reads %r which has no variable entry "
                                "in any reachable block" % (op.type, n),
                                blk.idx, op_idx, (n,),
                                suggestion="declare the variable or fix the "
                                "name in slot %r" % slot, block_path=path)
                        continue
                    if v.persistable or v.is_data \
                            or getattr(v, "type", None) == "lod_tensor_array":
                        continue
                    rep.add(ERROR, "WF001",
                            "op %s reads %r before any op produces it (not "
                            "persistable, not a feed)" % (op.type, n),
                            blk.idx, op_idx, (n,),
                            suggestion="feed it, mark it persistable, or "
                            "reorder the producing op before op %d" % op_idx,
                            block_path=path)
            defined.update(n for n in op.output_arg_names if n)

        # WF003: outputs nobody reads (advisory: auxiliary outputs such as
        # softmax_with_cross_entropy's Softmax routinely go unread)
        for op_idx, op in ops:
            for n in op.output_arg_names:
                if not n or n in global_reads or n in fetch \
                        or _is_gradish(n):
                    continue
                v = blk._find_var_recursive(n)
                if v is not None and (v.persistable or v.is_data):
                    continue
                rep.add(INFO, "WF003",
                        "output %r of op %s is never read, fetched, or "
                        "persisted" % (n, op.type),
                        blk.idx, op_idx, (n,), block_path=path)

    _check_reachability(program, fetch_names, rep)


def _check_reachability(program, fetch_names, rep):
    """WF004: reverse reachability from the fetch targets and the
    persistable writes; skipped without fetch targets."""
    if not fetch_names:
        return
    block = program.global_block()
    ops = _runtime_ops(block)
    needed = set(fetch_names)
    live = set()
    sub_reads = set()
    for blk in program.blocks[1:]:
        for _, op in _runtime_ops(blk):
            sub_reads.update(n for n in op.input_arg_names if n)
    for op_idx, op in reversed(ops):
        is_live = (op.type in _SIDE_EFFECT_OPS
                   or op.type in _STATEFUL_OPS
                   or "sub_block" in op.attrs)
        if not is_live:
            for n in op.output_arg_names:
                if not n:
                    continue
                if n in needed or n in sub_reads:
                    is_live = True
                    break
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    is_live = True
                    break
                # a parameter's gradient is consumed by the runtime (the
                # optimizer, a user's fetch of append_backward's results)
                base = n.split("@RENAME@")[0].split("@D")[0]
                if base.endswith(_GRAD_SUFFIX):
                    fwd = block._find_var_recursive(
                        base[:-len(_GRAD_SUFFIX)])
                    if fwd is not None and fwd.persistable:
                        is_live = True
                        break
        if is_live:
            live.add(op_idx)
            needed.update(n for n in op.input_arg_names if n)
    for op_idx, op in ops:
        if op_idx not in live:
            outs = tuple(n for n in op.output_arg_names if n)
            rep.add(WARNING, "WF004",
                    "op %s (outputs %s) cannot reach any fetch target or "
                    "persistable state: dead code" % (op.type, list(outs)),
                    block.idx, op_idx, outs,
                    suggestion="remove the op or fetch one of its outputs")


# -- family 2: type / shape flow ----------------------------------------------


def _meta(blk, names):
    out = []
    for n in names:
        v = blk._find_var_recursive(n) if n else None
        out.append(None if v is None else
                   (None if v.shape is None else tuple(v.shape), v.dtype))
    return tuple(out)


def _infer_key(op, blk):
    """What an op's shape inference reads: its type, attrs and the inputs'
    and outputs' metadata.  Ops that share it infer the same outputs (a
    transformer's layers repeat), so one inference serves them all."""
    from .registry import lower_attrs

    return (op.type, repr(sorted(lower_attrs(op.attrs).items())),
            tuple((s, _meta(blk, ns)) for s, ns in sorted(op.inputs.items())),
            tuple((s, _meta(blk, ns)) for s, ns in sorted(op.outputs.items())))


def _infer(opdef, op, blk, memo):
    """``opdef.run_infer_shape`` through ``memo``: a hit sets the outputs'
    shapes and dtypes as the first run of that key left them; a key whose
    inference raised raises again."""
    try:
        key = _infer_key(op, blk)
    except TypeError:
        key = None  # an unhashable attr: infer uncached
    hit = memo.get(key) if key is not None else None
    if hit is None:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                opdef.run_infer_shape(op, blk)
        except Exception:
            if key is not None:
                memo[key] = False
            raise
        if key is not None:
            memo[key] = [_meta(blk, ns) for _s, ns in
                         sorted(op.outputs.items())]
        return
    if hit is False:
        raise RuntimeError("shape inference failed for this signature")
    for (_s, names), metas in zip(sorted(op.outputs.items()), hit):
        for n, m in zip(names, metas):
            v = blk._find_var_recursive(n) if n else None
            if v is not None and m is not None:
                v.shape, v.dtype = m


def _check_type_shape(program, rep, paths):
    """Re-run each op's shape inference over a CLONE of the program (the
    inference writes shapes and dtypes into the block, and the verifier
    never changes the program it checks) and compare with the declared
    metadata."""
    clone = program.clone()
    memo = {}
    for blk in clone.blocks:
        path = paths.get(blk.idx)
        for op_idx, op in _runtime_ops(blk):
            opdef = _opdef_or_none(op.type)
            if opdef is None:
                continue  # WF002 has it
            in_names = set(op.input_arg_names)
            declared = {}
            for n in op.output_arg_names:
                if not n or n in declared or n in in_names:
                    continue  # in-place outputs keep their declared meta
                v = blk._find_var_recursive(n)
                if v is None:
                    continue
                declared[n] = (v.shape, v.dtype)
                v.dtype = None  # the inference re-derives it
            try:
                _infer(opdef, op, blk, memo)
            except Exception:
                for n, (shape, dtype) in declared.items():
                    v = blk._find_var_recursive(n)
                    v.shape, v.dtype = shape, dtype
                continue
            for n, (shape, dtype) in declared.items():
                v = blk._find_var_recursive(n)
                if v.dtype is None:
                    v.dtype = dtype  # the inference had no opinion
                elif dtype is not None \
                        and _canon_dtype(v.dtype) != _canon_dtype(dtype):
                    rep.add(ERROR, "TS001",
                            "op %s output %r is declared %s but the "
                            "lowering produces %s"
                            % (op.type, n, dtype, v.dtype),
                            blk.idx, op_idx, (n,),
                            suggestion="fix the var's declared dtype (or "
                            "the op's lowering/infer_shape)",
                            block_path=path)
                if shape is not None and _shapes_conflict(shape, v.shape):
                    rep.add(ERROR, "TS002",
                            "op %s output %r is declared shape %s but the "
                            "lowering produces %s"
                            % (op.type, n, list(shape), list(v.shape)),
                            blk.idx, op_idx, (n,),
                            suggestion="fix the var's declared shape (or "
                            "the op's lowering/infer_shape)",
                            block_path=path)

    _check_grad_consistency(program, rep)


def _check_grad_consistency(program, rep):
    """TS003: each ``X@GRAD`` agrees with its forward ``X`` (pass-local
    renames stripped); only shape contradictions and a change of kind
    (float vs int/bool) count, as AMP narrows float widths."""
    for blk in program.blocks:
        for name, gvar in list(blk.vars.items()):
            base = name.split("@RENAME@")[0].split("@D")[0]
            if not base.endswith(_GRAD_SUFFIX):
                continue
            fwd_name = base[:-len(_GRAD_SUFFIX)]
            fvar = blk._find_var_recursive(fwd_name)
            if fvar is None:
                continue
            if _shapes_conflict(fvar.shape, gvar.shape):
                rep.add(WARNING, "TS003",
                        "grad var %r has shape %s but forward var %r has "
                        "shape %s" % (name, list(gvar.shape), fwd_name,
                                      list(fvar.shape)),
                        blk.idx, None, (name, fwd_name),
                        suggestion="the grad maker or infer_shape for the "
                        "producing op disagrees with the forward")
            fk, gk = _dtype_kind(fvar.dtype), _dtype_kind(gvar.dtype)
            if fk is not None and gk is not None and fk != gk:
                rep.add(WARNING, "TS003",
                        "grad var %r is %s but forward var %r is %s"
                        % (name, gvar.dtype, fwd_name, fvar.dtype),
                        blk.idx, None, (name, fwd_name))


# -- entry points -------------------------------------------------------------


def verify_program(program, feed_names=(), fetch_names=(), scope_names=None,
                   label=None):
    """Run the rule families over ``program`` -> VerifyReport.

    ``feed_names`` / ``fetch_names`` sharpen WF001 and WF004 as the
    executor sees the run; ``scope_names`` (names already in the run's
    scope) keeps WF001 precise for programs reading pre-set values."""
    rep = VerifyReport(label=label or ("program #%d"
                                       % getattr(program, "_uid", -1)))
    paths = _block_paths(program)
    for chk in (lambda: _check_wellformed(program, feed_names, fetch_names,
                                          scope_names, rep, paths),
                lambda: _check_type_shape(program, rep, paths)):
        try:
            chk()
        except Exception as exc:  # a verifier fault never stops a run
            warnings.warn("static check pass failed internally: %r" % exc,
                          ProgramVerifyWarning, stacklevel=2)
    return rep


def _mode():
    from .. import flags

    return flags.flag("FLAGS_static_check") or "off"


def _dispatch(rep, mode):
    """Count each error and warning into telemetry, raise the report in
    ``error`` mode when it holds an error, else warn once with it."""
    from . import telemetry

    flagged = rep.errors + rep.warnings
    if not flagged:
        return rep
    for d in flagged:
        telemetry.inc("static_check_warnings", 1, rule=d.rule)
    if mode == "error" and rep.errors:
        raise ProgramVerificationError(rep)
    warnings.warn(rep.format(include_info=False), ProgramVerifyWarning,
                  stacklevel=3)
    return rep


_checked = {}
_CHECKED_CAP = 1024


def checked_reports():
    """The memoized reports of ``check_before_compile``, oldest first (one
    a plan miss that verified; at most the memo's cap)."""
    return list(_checked.values())


def check_before_compile(program, feed_names, fetch_names, scope=None,
                         feed_shapes=None):
    """The Executor's plan-miss hook.  ``off`` returns after one flag
    read; ``warn`` warns and counts; ``error`` raises
    ProgramVerificationError.  Reports are memoized per (program, version,
    feeds, fetches, feed shapes, mode)."""
    mode = _mode()
    if mode == "off":
        return None
    shape_sig = tuple(sorted((n, tuple(s))
                             for n, s in (feed_shapes or {}).items()))
    key = (getattr(program, "_uid", id(program)), program.version,
           tuple(sorted(feed_names)), tuple(fetch_names), shape_sig, mode)
    if key in _checked:
        return _checked[key]
    t0 = time.perf_counter()
    scope_names = set()
    s = scope
    while s is not None:
        scope_names.update(getattr(s, "_vars", ()))
        s = getattr(s, "parent", None)
    rep = verify_program(program, feed_names, fetch_names, scope_names)
    rep.ms = (time.perf_counter() - t0) * 1e3
    if len(_checked) >= _CHECKED_CAP:
        _checked.clear()
    _checked[key] = rep
    return _dispatch(rep, mode)
