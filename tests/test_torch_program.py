"""The PyTorch port's Program front end (paddle_tpu_torch/framework.py,
layers/, core/registry.py) held against the JAX package's on the CPU.

Built under the same unique-name guard, the port's BERT_TINY encoder
must give main and startup programs EQUAL to the reference's through
``to_dict()`` (op types and order, input/output names, attrs, variable
shapes and dtypes); the JSON IR must round-trip both ways; and static
shape inference (reshape2's 0 and -1, a -1 batch through the default
meta-tensor inference) must agree with the reference's symbolic one."""

import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.utils import unique_name as tun

SEQ = 16

# the op surface of the BERT inference program (main and startup)
BERT_OPS = {"elementwise_add", "mul", "reshape2", "transpose2",
            "fused_dropout_add_ln", "lookup_table", "flash_attention",
            "gelu", "layer_norm", "matmul", "scale", "unsqueeze2",
            "fill_constant", "uniform_random"}


def _jax_bert(is_test=True):
    main, startup = fluid.Program(), fluid.Program()
    with jun.guard(), fluid.program_guard(main, startup):
        jbert.bert_encoder(jbert.BERT_TINY, SEQ, is_test=is_test)
    return main, startup


def _port_bert(is_test=True):
    main, startup = tfw.Program(), tfw.Program()
    with tun.guard(), tfw.program_guard(main, startup):
        tbert.bert_encoder(tbert.BERT_TINY, SEQ, is_test=is_test)
    return main, startup


@pytest.mark.parametrize("which", ["main", "startup"])
def test_bert_tiny_program_equals_reference(which):
    jm, js = _jax_bert()
    tm, ts = _port_bert()
    want = (jm if which == "main" else js).to_dict()
    got = (tm if which == "main" else ts).to_dict()
    for wop, gop in zip(want["blocks"][0]["ops"], got["blocks"][0]["ops"]):
        assert gop == wop
    for wv, gv in zip(want["blocks"][0]["vars"], got["blocks"][0]["vars"]):
        assert gv == wv
    assert got == want


def test_bert_ops_are_the_ported_surface():
    tm, ts = _port_bert()
    types = {op.type for p in (tm, ts) for op in p.global_block().ops}
    assert types == BERT_OPS
    assert BERT_OPS <= set(registry.all_op_types())
    counts = {}
    for op in tm.global_block().ops:
        counts[op.type] = counts.get(op.type, 0) + 1
    layers = tbert.BERT_TINY.layers
    assert counts["flash_attention"] == layers
    assert counts["fused_dropout_add_ln"] == 2 * layers
    assert counts["layer_norm"] == 1


def test_json_ir_round_trips_both_ways():
    tm, _ = _port_bert()
    d = tm.to_dict()
    assert tfw.Program.from_dict(json.loads(json.dumps(d))).to_dict() == d
    # the port's IR is the reference's: each package reads the other's
    assert fluid.Program.from_dict(d).to_dict() == d
    jm, _ = _jax_bert()
    assert tfw.Program.from_dict(jm.to_dict()).to_dict() == jm.to_dict()


def test_clone_for_test_sets_is_test():
    tm, _ = _port_bert()
    jm, _ = _jax_bert()
    tc, jc = tm.clone(for_test=True), jm.clone(for_test=True)
    assert tc.to_dict() == jc.to_dict()
    fa = [op for op in tc.global_block().ops if op.type == "flash_attention"]
    assert fa and all(op.attr("is_test") for op in fa)
    assert not any(op.attr("is_test") for op in tm.global_block().ops
                   if op.type == "flash_attention")


def _shapes(pkg_layers, program_mod, build):
    main, startup = program_mod.Program(), program_mod.Program()
    guard = tun.guard if program_mod is tfw else jun.guard
    with guard(), program_mod.program_guard(main, startup):
        outs = build(pkg_layers)
    blk = main.global_block()
    return [(blk.var(o.name).shape, blk.var(o.name).dtype) for o in outs]


SHAPE_CASES = {
    "reshape2 0 copies dims, -1 stays batch": lambda L: [
        L.reshape(L.data("x", shape=[6, 4]), [0, 0, 2, 2])],
    "reshape2 with a -1 batch keeps -1 unresolved": lambda L: [
        L.reshape(L.data("x", shape=[6, 4]), [0, -1])],
    "reshape2 resolves -1 for a known shape": lambda L: [
        L.reshape(L.data("x", shape=[3, 4], append_batch_size=False),
                  [-1, 2])],
    "transpose2 and unsqueeze2 over a batch": lambda L: [
        L.transpose(L.data("x", shape=[6, 4]), [0, 2, 1]),
        L.unsqueeze(L.data("y", shape=[5]), [1])],
    "mul flattening and matmul over a batch": lambda L: [
        L.fc(L.data("x", shape=[7, 3]), 5, num_flatten_dims=2),
        L.matmul(L.data("m", shape=[7, 1]), L.data("m2", shape=[7, 1]),
                 transpose_y=True, alpha=0.5)],
    "lookup_table squeezes [..., 1] ids": lambda L: [
        L.embedding(L.data("ids", shape=[9, 1], dtype="int64"), (11, 4))],
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_static_shapes_match_reference(case):
    build = SHAPE_CASES[case]
    assert _shapes(tlayers, tfw, build) == _shapes(fluid.layers, fluid,
                                                   build)


def test_reshape2_xshape_and_batch_stand_ins():
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[6, 4])
        y = tlayers.reshape(x, [0, 0, 2, 2])
        z = tlayers.scale(y, scale=2.0)
    blk = main.global_block()
    assert blk.var(y.name).shape == (-1, 6, 2, 2)
    xshape = main.global_block().ops[0].output("XShape")[0]
    assert blk.var(xshape).shape == (0, -1, 6, 4)
    # default inference: the batch dim follows the stand-ins, others stay
    assert blk.var(z.name).shape == (-1, 6, 2, 2)


def test_unknown_op_type_names_the_ported_ones():
    with pytest.raises(ValueError,
                       match="unknown op type 'conv2d_transpose'"):
        registry.get_op_def("conv2d_transpose")


def test_startup_initialisers_shapes_dtypes_and_ranges():
    """Startup draws come from torch generators: never the reference's
    values, but the same shapes, dtypes and ranges; a seeded startup is
    reproducible."""
    from paddle_tpu_torch.core import Executor, Scope

    tm, ts = _port_bert()
    ts.random_seed = 3

    def init():
        scope = Scope()
        Executor("cpu").run(ts, scope=scope)
        return scope

    s1, s2 = init(), init()
    for op in ts.global_block().ops:
        name = op.output("Out")[0]
        a = s1.find_var(name).get_tensor().numpy()
        assert a.shape == tuple(op.attr("shape")) and a.dtype == np.float32
        if op.type == "fill_constant":
            assert np.all(a == op.attr("value"))
        else:
            assert a.min() >= op.attr("min") and a.max() < op.attr("max")
            assert a.std() > 0.2 * op.attr("max")
        np.testing.assert_array_equal(
            a, s2.find_var(name).get_tensor().numpy())
