"""Training programs and grad ops of the PyTorch port
(paddle_tpu_torch/backward.py, optimizer.py, ir.py, core/registry.py,
ops/) held against the JAX package on the CPU.

* Programs: built under the same unique-name guard, the BERT_TINY-width
  ``build_pretrain`` at dropout 0 and the MNIST MLP of
  ``models.bundled_builders()`` with ``Adam(lr).minimize(loss)`` give main
  and startup programs EQUAL to the reference's through ``to_dict()``
  (op types, order, slots, attrs with op_role/op_role_var, variable shapes
  and dtypes), and so does the main program after the optimizer-fusion
  pass (one fused_adam).
* Grad ops: each explicit grad lowering of the port (mul, elementwise_add,
  layer_norm, flash_attention, fused_dropout_add_ln) and each synthesized
  vjp replay on the path (gelu, relu, softmax, lookup_table, gather,
  softmax_with_cross_entropy, mean, reshape2, transpose2) gives the JAX
  grad op's gradients on the same numpy-seeded inputs, atol 1e-5 (f32,
  another library's summation order; the attention grads 2e-5, as the
  forward's tests allow for its online softmax).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu import models as jmodels
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.models import bert as jbert
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import Executor, Scope
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.utils import unique_name as tun

SEQ = 16
ATOL = 1e-5
ATOL_ATTENTION = 2e-5


def tiny(mod):
    """BERT_TINY widths at dropout 0, the slice's cut."""
    return mod.BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                          ffn=128, max_pos=64, dropout=0.0)


def jax_programs(model):
    main, startup = fluid.Program(), fluid.Program()
    with jun.guard(), fluid.program_guard(main, startup):
        if model == "bert_tiny":
            jbert.build_pretrain(tiny(jbert), seq_len=SEQ, lr=1e-3)
        else:
            _feeds, (loss, _acc) = jmodels.bundled_builders()["mnist_mlp"]()
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup


def port_programs(model):
    main, startup = tfw.Program(), tfw.Program()
    with tun.guard(), tfw.program_guard(main, startup):
        if model == "bert_tiny":
            tbert.build_pretrain(tiny(tbert), seq_len=SEQ, lr=1e-3)
        else:
            _img, _label, _logits, loss, _acc = tmnist.build_mlp()
            topt.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup


def assert_programs_equal(got, want):
    g, w = got.to_dict(), want.to_dict()
    gops, wops = g["blocks"][0]["ops"], w["blocks"][0]["ops"]
    assert [o["type"] for o in gops] == [o["type"] for o in wops]
    for gop, wop in zip(gops, wops):
        assert gop == wop
    for gv, wv in zip(g["blocks"][0]["vars"], w["blocks"][0]["vars"]):
        assert gv == wv
    assert g == w


@pytest.mark.parametrize("model", ["bert_tiny", "mnist_mlp"])
@pytest.mark.parametrize("which", ["main", "startup", "fused main"])
def test_training_programs_equal_reference(model, which):
    jm, js = jax_programs(model)
    tm, ts = port_programs(model)
    if which == "fused main":
        jir.apply_pass("fuse_optimizer_ops_pass", jm, None)
        tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
        assert sum(op.type == "fused_adam" for op in tm.global_block().ops) \
            == 1
        assert not any(op.type == "adam" for op in tm.global_block().ops)
    got, want = {"startup": (ts, js)}.get(which, (tm, jm))
    assert_programs_equal(got, want)


def test_bert_training_op_surface():
    """The op counts of the issue's reference run: 14 mul, 2 flash
    attention, 4 epilogues, 43 adam ops fused into one."""
    tm, _ts = port_programs("bert_tiny")
    counts = Counter(op.type for op in tm.global_block().ops)
    assert counts["adam"] == 43 and counts["mul"] == 14
    assert counts["flash_attention"] == counts["flash_attention_grad"] == 2
    assert counts["fused_dropout_add_ln"] == 4
    assert counts["fused_dropout_add_ln_grad"] == 4
    assert counts["sum"] == 4
    # the mask path is data: no grads of matmul, scale, unsqueeze2
    for t in ("matmul_grad", "scale_grad", "unsqueeze2_grad"):
        assert t not in counts
    tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
    counts = Counter(op.type for op in tm.global_block().ops)
    assert counts["fused_adam"] == 1 and "adam" not in counts


def test_fusion_skips_a_group_with_a_hazard():
    """An op between two members that reads a member's state keeps the
    group unfused, in both packages."""
    tm, _ = port_programs("mnist_mlp")
    block = tm.global_block()
    adams = [i for i, op in enumerate(block.ops) if op.type == "adam"]
    block._insert_op(adams[1], type="scale",
                     inputs={"X": [block.ops[adams[0]].input("Param")[0]]},
                     outputs={"Out": [block.create_var(name="peek",
                                                       dtype="float32")]})
    version = tm.version
    tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
    assert tm.version == version
    assert sum(op.type == "adam" for op in block.ops) == len(adams)


def test_tensor_layers_match_reference():
    """create_global_var and fill_constant build the reference's programs
    and the port's executor fills them."""
    def build(L):
        g = L.create_global_var([2, 3], 0.5, "float32", persistable=True)
        c = L.fill_constant([4], "int64", 7)
        return g, c

    jm, js = fluid.Program(), fluid.Program()
    with jun.guard(), fluid.program_guard(jm, js):
        build(fluid.layers)
    tm, ts = tfw.Program(), tfw.Program()
    with tun.guard(), tfw.program_guard(tm, ts):
        g, c = build(tlayers)
    assert_programs_equal(tm, jm)
    assert_programs_equal(ts, js)
    scope = Scope()
    exe = Executor(tfw.CPUPlace())
    exe.run(ts, scope=scope)
    cv, = exe.run(tm, fetch_list=[c], scope=scope)
    gv = scope.find_var(g.name).get_tensor().numpy()
    np.testing.assert_array_equal(gv, np.full((2, 3), 0.5, np.float32))
    np.testing.assert_array_equal(cv, np.full(4, 7, np.int64))


# -- grad ops, op by op -------------------------------------------------------


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jax_grad(op_type, args, attrs):
    fn = jreg.get_op_def(op_type).lower
    out = fn(JCtx(mode="eager"), *[None if a is None else jnp.asarray(a)
                                   for a in args], **attrs)
    return [None if o is None else np.asarray(o) for o in out]


def _port_grad(op_type, args, attrs):
    fn = treg.get_op_def(op_type).lower
    out = fn(TCtx(torch.device("cpu")),
             *[None if a is None else torch.from_numpy(np.array(a))
               for a in args], **attrs)
    return [None if o is None else o.numpy() for o in out]


def _auto_args(rng, op_type, ins, attrs, out_grad_scale=1.0):
    """Forward inputs, then (output, output grad) per output slot, the
    layout of the auto maker's grad op; outputs by the JAX forward."""
    fwd = jreg.get_op_def(op_type)
    outs = fwd.lower(JCtx(mode="eager"),
                     *[None if a is None else jnp.asarray(a) for a in ins],
                     **attrs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    args = list(ins)
    for o in outs:
        if o is None or not jnp.issubdtype(o.dtype, jnp.floating):
            args += [None if o is None else np.asarray(o), None]
        else:
            args += [np.asarray(o),
                     _rand(rng, *o.shape, scale=out_grad_scale)]
    return args


def _cases():
    r = np.random.RandomState(0)
    ids = r.randint(0, 11, (3, 5, 1)).astype(np.int64)
    index = np.array([4, 0, 4, 7, 2, 4], np.int64)   # repeats accumulate
    label = r.randint(0, 9, (6, 1)).astype(np.int64)
    return {
        "mul": (["X", "Y"], [_rand(r, 3, 5, 7), _rand(r, 7, 4)],
                {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        "elementwise_add": (["X", "Y"], [_rand(r, 3, 5, 7), _rand(r, 7)],
                            {"axis": 2}),
        "layer_norm": (["X", "Scale", "Bias"],
                       [_rand(r, 3, 5, 8, scale=2.0), _rand(r, 8) + 1.0,
                        _rand(r, 8)], {"epsilon": 1e-5,
                                       "begin_norm_axis": 2}),
        "gelu": (["X"], [_rand(r, 4, 9)], {"approximate": False}),
        "relu": (["X"], [_rand(r, 4, 9)], {}),
        "softmax": (["X"], [_rand(r, 4, 9)], {"axis": -1}),
        "lookup_table": (["W", "Ids"], [_rand(r, 11, 6), ids],
                         {"padding_idx": -1}),
        "gather": (["X", "Index"], [_rand(r, 8, 6), index],
                   {"overwrite": True}),
        "softmax_with_cross_entropy": (
            ["Logits", "Label"], [_rand(r, 6, 9, scale=3.0), label],
            {"soft_label": False, "ignore_index": -100,
             "numeric_stable_mode": True, "axis": -1}),
        "mean": (["X"], [_rand(r, 5, 7)], {}),
        "reshape2": (["X", "Shape", "ShapeTensor"],
                     [_rand(r, 3, 4, 6), None, None], {"shape": [0, 0, 2, 3]}),
        "transpose2": (["X"], [_rand(r, 2, 3, 4, 5)], {"axis": [0, 2, 1, 3]}),
    }


@pytest.mark.parametrize("op_type", sorted(_cases()))
def test_grad_op_matches_reference(op_type):
    """The grad op of the auto maker, fed the same forward inputs, outputs
    and output grads: explicit in the port for mul, elementwise_add,
    layer_norm and relu, the vjp replay for the rest."""
    _slots, ins, attrs = _cases()[op_type]
    rng = np.random.RandomState(1)
    args = _auto_args(rng, op_type, ins, attrs)
    if op_type == "layer_norm":   # Mean/Variance are stop-gradient outputs
        args[6] = args[8] = None
    want = _jax_grad(op_type + "_grad", args, attrs)
    got = _port_grad(op_type + "_grad", args, attrs)
    assert len(got) == len(want)
    for g, w, x in zip(got, want, ins):
        if w is None or x is None or not np.issubdtype(x.dtype, np.floating):
            assert g is None or not np.issubdtype(x.dtype, np.floating)
            continue
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_explicit_grads_take_precedence():
    for t in ("mul", "elementwise_add", "layer_norm"):
        low = treg.get_op_def(t + "_grad").lower
        assert low.__name__ == t + "_grad"
    assert treg.get_op_def("gelu_grad").lower.__name__ == "grad_lower"


def _attention_inputs(rng, bb=2, h=3, s=11, d=8):
    q, k, v = (_rand(rng, bb, h, s, d) for _ in range(3))
    keep = (rng.rand(bb, 1, 1, s) > 0.3).astype(np.float32)
    keep[..., 0] = 1.0
    bias = np.ascontiguousarray(np.broadcast_to((1 - keep) * -1e4,
                                                (bb, 1, s, s)))
    return q, k, v, bias


def test_flash_attention_grad_op_matches_reference():
    """Each grad op from its own package's forward: the port's flash route
    saves the real lse in Lse (the reference's holds a placeholder and its
    grad replays the forward)."""
    rng = np.random.RandomState(2)
    q, k, v, bias = _attention_inputs(rng)
    attrs = {"causal": False, "scale": 0.0, "layout": "BHSD",
             "dropout_prob": 0.0, "is_test": False}
    dout = _rand(rng, *q.shape)

    def grad_args(fwd):
        out, mask, seed, lse = (np.asarray(o) for o in fwd)
        return [q, k, v, bias, mask, out, seed, lse, dout]

    jfwd = jreg.get_op_def("flash_attention").lower(
        JCtx(mode="eager"), q, k, v, bias, **attrs)
    tfwd = treg.get_op_def("flash_attention").lower(
        TCtx(torch.device("cpu")), *(torch.from_numpy(a)
                                     for a in (q, k, v, bias)), **attrs)
    want = _jax_grad("flash_attention_grad", grad_args(jfwd), attrs)
    got = _port_grad("flash_attention_grad", grad_args(tfwd), attrs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL_ATTENTION, rtol=0)


@pytest.mark.parametrize("axis", [1, 2])
def test_fused_dropout_add_ln_grad_op_matches_reference(axis):
    rng = np.random.RandomState(3)
    x, y = _rand(rng, 3, 5, 16, scale=2.0), _rand(rng, 3, 5, 16)
    h = int(np.prod(x.shape[axis:]))
    g, b = _rand(rng, h) + 1.0, _rand(rng, h)
    attrs = {"dropout_prob": 0.0, "is_test": False, "epsilon": 1e-5,
             "begin_norm_axis": axis, "fix_seed": False, "seed": 0}
    _z, r, mean, var, seed = jreg.get_op_def("fused_dropout_add_ln").lower(
        JCtx(mode="eager"), x, y, g, b, **attrs)
    dz = _rand(rng, *x.shape)
    args = [np.asarray(r), g, np.asarray(seed), np.asarray(mean),
            np.asarray(var), dz]
    want = _jax_grad("fused_dropout_add_ln_grad", args, attrs)
    got = _port_grad("fused_dropout_add_ln_grad", args, attrs)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv, wv, atol=ATOL, rtol=0)


def test_backward_roles_and_param_grads():
    """append_backward stamps the loss grad Backward|Loss, grad ops
    Backward with [param, grad] op_role_var pairs, and the update ops
    Optimize; every trainable parameter gets a gradient."""
    tm, _ = port_programs("bert_tiny")
    ops = tm.global_block().ops
    roles = Counter(op.attr("op_role") for op in ops)
    assert roles[tfw.OpRole.Backward | tfw.OpRole.Loss] == 1
    assert roles[tfw.OpRole.Optimize] == 43
    params = {p.name for p in tm.global_block().all_parameters()}
    paired = set()
    for op in ops:
        rv = op.attrs.get(tfw.OP_ROLE_VAR_KEY, [])
        paired.update(rv[0::2])
        assert all(g == p + tfw.GRAD_SUFFIX
                   for p, g in zip(rv[0::2], rv[1::2]))
    assert paired == params
