"""Program-level IR passes.

Counterpart of ``paddle_tpu/ir.py`` (``Pass``, ``register_pass``,
``apply_pass``, ``_commit_replacements:352``, ``FuseOptimizerOpsPass:556``
and four of the predictor's passes: ``delete_dropout_pass:76``,
``conv_bn_fuse_pass:103``, ``fc_fuse_pass:188``,
``fuse_elewise_add_act_pass:460``).  ``INFERENCE_PASSES`` is the
reference predictor's pipeline under ``ir_optim()``, in its order; the
three of them not ported (``multihead_matmul_fuse_pass``,
``repeated_fc_relu_fuse_pass``, ``seqpool_concat_fuse_pass``) are
registered as checks that raise where the reference's pass would rewrite
the program, so a predictor never serves a program the reference would
have served rewritten.
"""

import numpy as np
import torch

__all__ = ["Pass", "register_pass", "get_pass", "apply_pass",
           "INFERENCE_PASSES", "FuseOptimizerOpsPass"]

# the reference predictor's passes under ir_optim(), in its order
# (paddle_tpu/inference.py:230-237)
INFERENCE_PASSES = ("delete_dropout_pass", "conv_bn_fuse_pass",
                    "multihead_matmul_fuse_pass", "fc_fuse_pass",
                    "repeated_fc_relu_fuse_pass", "seqpool_concat_fuse_pass",
                    "fuse_elewise_add_act_pass")

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


def _build_consumers(block):
    """name -> [ops reading it]."""
    consumers = {}
    for op in block.ops:
        for n in op.input_arg_names:
            consumers.setdefault(n, []).append(op)
    return consumers


def _sole_consumer(consumers, name, protected):
    """The single op reading ``name``, or None if 0 or many, or if the name
    is protected."""
    cons = consumers.get(name, [])
    if len(cons) != 1 or name in protected:
        return None
    return cons[0]


@register_pass("delete_dropout_pass")
class DeleteDropoutPass(Pass):
    """An is_test upscale_in_train dropout (the identity) becomes
    ``assign``, which keeps every output produced; a downgrade_in_infer
    one rescales and stays."""

    def apply(self, program, scope):
        from .framework import Operator

        block = program.global_block()
        replaced = {}
        for op in block.ops:
            if (op.type == "dropout" and op.attrs.get("is_test")
                    and op.attrs.get("dropout_implementation")
                    == "upscale_in_train"):
                replaced[id(op)] = Operator(
                    block, type="assign", inputs={"X": [op.input("X")[0]]},
                    outputs={"Out": [op.output("Out")[0]]}, attrs={})
        block.ops = [replaced.get(id(op), op) for op in block.ops]
        program._bump_version()


def _scope_array(scope, name):
    v = scope.find_var(name) if scope is not None else None
    if v is None or not v.get_tensor()._is_initialized():
        return None
    return np.asarray(v.get_tensor().numpy())


def _scope_set(scope, name, array):
    """Store ``array`` under ``name`` on the device its old value is on."""
    old = scope.find_var(name)
    old = old.get_tensor().get() if old is not None else None
    t = torch.from_numpy(np.ascontiguousarray(array))
    scope.var(name).set(t.to(old.device) if isinstance(old, torch.Tensor)
                        else t)


@register_pass("conv_bn_fuse_pass")
class ConvBNFusePass(Pass):
    """Fold an inference batch_norm into the conv2d before it: W' = W
    gamma / std per output channel, and the BN op becomes one
    elementwise_add (axis 1) of b' = beta - mean gamma / std.  The folded
    values are computed in numpy f32 exactly as the reference computes
    them.  A conv whose output has another reader, or whose filter
    another conv shares, stays."""

    def apply(self, program, scope):
        from .framework import Operator

        block = program.global_block()
        consumers = _build_consumers(block)
        filter_uses = {}
        for op in block.ops:
            if op.type == "conv2d":
                f = op.input("Filter")[0]
                filter_uses[f] = filter_uses.get(f, 0) + 1
        new_ops, ops, i = [], block.ops, 0
        while i < len(ops):
            op = ops[i]
            bn = None
            if op.type == "conv2d":
                cons = consumers.get(op.output("Output")[0], [])
                if (len(cons) == 1 and cons[0].type == "batch_norm"
                        and cons[0].attrs.get("is_test")
                        and filter_uses.get(op.input("Filter")[0], 0) == 1):
                    bn = cons[0]
            vals = {}
            if bn is not None:
                names = {s: bn.input(s)[0] for s in
                         ("Scale", "Bias", "Mean", "Variance")}
                names["W"] = op.input("Filter")[0]
                vals = {s: _scope_array(scope, n) for s, n in names.items()}
            if bn is None or any(v is None for v in vals.values()):
                new_ops.append(op)
                i += 1
                continue
            eps = float(bn.attrs.get("epsilon", 1e-5))
            factor = vals["Scale"] / np.sqrt(vals["Variance"] + eps)
            w = vals["W"]
            _scope_set(scope, names["W"],
                       (w * factor.reshape(-1, 1, 1, 1)).astype(w.dtype))
            bias = vals["Bias"] - vals["Mean"] * factor
            # keyed by the BN output: unique per fused pair
            bias_name = bn.output("Y")[0] + "@bn_fused_bias"
            block.create_var(name=bias_name, shape=[len(bias)],
                             dtype="float32", persistable=True)
            _scope_set(scope, bias_name, bias.astype("float32"))
            new_ops.append(op)
            new_ops.append(Operator(
                block, type="elementwise_add",
                inputs={"X": [op.output("Output")[0]], "Y": [bias_name]},
                outputs={"Out": [bn.output("Y")[0]]}, attrs={"axis": 1}))
            # every op up to the BN stays, the BN goes (topological emit
            # order keeps them contiguous)
            i += 1
            while ops[i] is not bn:
                new_ops.append(ops[i])
                i += 1
            i += 1
        block.ops = new_ops
        program._bump_version()


@register_pass("fc_fuse_pass")
class FCFusePass(Pass):
    """mul(X, W) + elementwise_add(., b) [+ relu] becomes one ``fc``: the
    mul output feeds only the add, the bias is a 1-D persistable
    broadcast along the last dim, and for the act variant the add output
    feeds only the relu."""

    def apply(self, program, scope):
        from .framework import Operator

        block = program.global_block()
        consumers = _build_consumers(block)

        def only_consumer(name, want_type):
            op = _sole_consumer(consumers, name, self.protected)
            return op if op is not None and op.type == want_type else None

        skip, new_ops = set(), []
        for op in block.ops:
            if id(op) in skip:
                continue
            add = None
            if op.type == "mul" \
                    and int(op.attrs.get("y_num_col_dims", 1)) == 1:
                add = only_consumer(op.output("Out")[0], "elementwise_add")
            bvar = None if add is None \
                else block._find_var_recursive(add.input("Y")[0])
            if (bvar is None or not bvar.persistable or bvar.shape is None
                    or len(bvar.shape) != 1
                    or int(add.attrs.get("axis", -1)) not in (-1, 1)
                    or add.input("X")[0] != op.output("Out")[0]):
                new_ops.append(op)
                continue
            out_name, act = add.output("Out")[0], ""
            skip.add(id(add))
            relu = only_consumer(out_name, "relu")
            if relu is not None:
                act, out_name = "relu", relu.output("Out")[0]
                skip.add(id(relu))
            new_ops.append(Operator(
                block, type="fc",
                inputs={"Input": [op.input("X")[0]], "W": [op.input("Y")[0]],
                        "Bias": [add.input("Y")[0]]},
                outputs={"Out": [out_name]},
                attrs={"in_num_col_dims": int(op.attrs.get(
                    "x_num_col_dims", 1)), "activation_type": act}))
        block.ops = new_ops
        program._bump_version()


@register_pass("fuse_elewise_add_act_pass")
class FuseElewiseAddActPass(Pass):
    """elementwise_add -> {relu, tanh, sigmoid} becomes one
    ``fused_elemwise_activation``; the add's output stays produced as its
    IntermediateOut."""

    ACTS = ("relu", "tanh", "sigmoid")

    def apply(self, program, scope):
        from .framework import Operator

        block = program.global_block()
        consumers = _build_consumers(block)
        replaced = {}
        for op in block.ops:
            if op.type != "elementwise_add" or id(op) in replaced:
                continue
            nxt = _sole_consumer(consumers, op.output("Out")[0],
                                 self.protected)
            if nxt is None or nxt.type not in self.ACTS \
                    or id(nxt) in replaced:
                continue
            replaced[id(op)] = Operator(
                block, type="fused_elemwise_activation",
                inputs={"X": [op.input("X")[0]], "Y": [op.input("Y")[0]]},
                outputs={"Out": [nxt.output("Out")[0]],
                         "IntermediateOut": [op.output("Out")[0]]},
                attrs={"functor_list": [nxt.type, "elementwise_add"],
                       "axis": int(op.attrs.get("axis", -1)),
                       "save_intermediate_out": True})
            replaced[id(nxt)] = None
        _commit_replacements(program, block, replaced)


class _UnportedPass(Pass):
    """A reference pass the port does not carry: raises where it would
    rewrite the program (``_would_rewrite``), and is a no-op elsewhere."""

    def _would_rewrite(self, block):
        raise NotImplementedError

    def apply(self, program, scope):
        block = program.global_block()
        if self._would_rewrite(block):
            raise NotImplementedError(
                "%s is not ported yet and would rewrite this program "
                "(ROADMAP, the predictor's passes)" % self.name)


@register_pass("multihead_matmul_fuse_pass")
class MultiheadMatmulFuseCheck(_UnportedPass):
    """The reference fuses matmul(Q, K^T) [+ mask add] -> softmax ->
    [assign] -> matmul(., V) over rank-4 Q, K, V into flash_attention
    (``paddle_tpu/ir.py:378``)."""

    def _would_rewrite(self, block):
        consumers = _build_consumers(block)

        def rank(name):
            v = block._find_var_recursive(name)
            return None if v is None or v.shape is None else len(v.shape)

        def next_op(op):
            return _sole_consumer(consumers, op.output("Out")[0],
                                  self.protected)

        for op in block.ops:
            if op.type != "matmul" or not op.attrs.get("transpose_Y") \
                    or op.attrs.get("transpose_X") \
                    or rank(op.input("X")[0]) != 4 \
                    or rank(op.input("Y")[0]) != 4:
                continue
            prev, cur = op, next_op(op)
            if cur is not None and cur.type == "elementwise_add":
                if cur.input("X")[0] != op.output("Out")[0] \
                        or rank(cur.input("Y")[0]) != 4:
                    continue
                prev, cur = cur, next_op(cur)
            if cur is None or cur.type != "softmax" \
                    or cur.attrs.get("axis", -1) not in (-1, 3):
                continue
            prev, cur = cur, next_op(cur)
            while cur is not None and cur.type == "assign":
                prev, cur = cur, next_op(cur)
            if (cur is not None and cur.type == "matmul"
                    and not cur.attrs.get("transpose_X")
                    and not cur.attrs.get("transpose_Y")
                    and float(cur.attrs.get("alpha", 1.0)) == 1.0
                    and cur.input("X")[0] == prev.output("Out")[0]
                    and rank(cur.input("Y")[0]) == 4):
                return True
        return False


@register_pass("repeated_fc_relu_fuse_pass")
class RepeatedFCReluFuseCheck(_UnportedPass):
    """The reference fuses chains of two or more relu ``fc`` ops over 2-D
    inputs with biases into fusion_repeated_fc_relu
    (``paddle_tpu/ir.py:253``)."""

    def _would_rewrite(self, block):
        consumers = _build_consumers(block)

        def eligible(o):
            if o.type != "fc" or o.attrs.get("activation_type") != "relu" \
                    or int(o.attrs.get("in_num_col_dims", 1)) != 1 \
                    or not o.input("Bias"):
                return False
            v = block._find_var_recursive(o.input("Input")[0])
            return v is not None and v.shape is not None \
                and len(v.shape) == 2

        for op in block.ops:
            if eligible(op):
                nxt = _sole_consumer(consumers, op.output("Out")[0],
                                     self.protected)
                if nxt is not None and eligible(nxt):
                    return True
        return False


@register_pass("seqpool_concat_fuse_pass")
class SeqPoolConcatFuseCheck(_UnportedPass):
    """The reference fuses two or more sequence_pool branches feeding one
    concat into fusion_seqpool_concat (``paddle_tpu/ir.py:497``); the port
    has no sequence ops, so any such concat is flagged."""

    def _would_rewrite(self, block):
        producers = {n: op for op in block.ops
                     for n in op.output_arg_names}
        return any(
            op.type == "concat" and len(op.input("X")) >= 2
            and all(getattr(producers.get(n), "type", None)
                    == "sequence_pool" for n in op.input("X"))
            for op in block.ops)


@register_pass("fuse_optimizer_ops_pass")
class FuseOptimizerOpsPass(Pass):
    """Coalesce per-parameter sgd, momentum or adam ops into one
    ``fused_sgd`` / ``fused_momentum`` / ``fused_adam`` op.

    Groups ops sharing their hyperparameter attrs, LearningRate var and
    param dtype; a group of at least MIN_GROUP becomes one fused op over
    duplicable slots, placed where its last member was.  A group is
    skipped when an op between its first and last member reads or writes
    any of its state, or writes the shared LearningRate, or when an adam
    op takes per-op beta tensors.  Diverged beta pows are safe: the fused
    op applies each member's own bias correction.  Only params of rank
    <= MAX_PARAM_RANK fuse (the reference's FLAGS_fuse_optimizer_max_rank
    default, which keeps its 4-D conv kernels apart); BERT's params are
    all 1-D or 2-D, so its whole set is one group, and ResNet's BN scales
    and biases and its fc weight and bias are one group while each conv
    filter keeps its own momentum op (those interleave with the group's
    members but touch none of its state, so no hazard); DLRM's dense
    weights and biases are one sgd group."""

    MIN_GROUP = 4
    MAX_PARAM_RANK = 2
    _STATE_SLOTS = {"sgd": ("Param", "Grad"),
                    "momentum": ("Param", "Grad", "Velocity"),
                    "adam": ("Param", "Grad", "Moment1", "Moment2",
                             "Beta1Pow", "Beta2Pow")}
    _OUT_SLOTS = {"sgd": ("ParamOut",),
                  "momentum": ("ParamOut", "VelocityOut"),
                  "adam": ("ParamOut", "Moment1Out", "Moment2Out",
                           "Beta1PowOut", "Beta2PowOut")}
    _FUSED_ATTRS = {"sgd": (),
                    "momentum": ("mu", "use_nesterov",
                                 "regularization_method",
                                 "regularization_coeff"),
                    "adam": ("beta1", "beta2", "epsilon")}
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
