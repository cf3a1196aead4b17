"""The port's control flow held against the JAX package on the CPU.

* The reference's own programs (``tests/test_control_flow.py``'s nine
  and ``tests/test_dynamic_array_while.py``'s three), each built by both
  packages: the program dicts are equal, and the port's fetches equal the
  reference's (floats to RTOL, integers and masks exactly); the
  StaticRNN trains from the reference's initial state to its losses.
* The two forms of the reference's lowering, each difference pinned
  against the reference in both forms: a read past a tensor array's end
  (an IndexError of the list form, the buffer's zeros of the bounded
  form); ``lod_array_length`` (int64 in both); the capacity of a bounded
  array, checked where the index is a constant of the program; and a
  var only a skipped branch would create (absent after a constant
  predicate, zeros after a data-dependent one).
* The ops the loops need (``logical_not``, ``logical_or``,
  ``logical_xor``, ``arg_max``, ``arg_min``, ``reduce_mean``, ``tanh``,
  ``sigmoid``, ``square``) against the reference's lowerings, the host
  syncs a step counts (one a predicate or loop condition read, none for
  a branch with no ops), and the seed of a random op in a loop body.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.layers import control_flow as tcf
from paddle_tpu_torch.utils import unique_name as tun

RTOL = 1e-5
RNN_LOSS_RTOL = 1e-4

J = types.SimpleNamespace(fw=fluid, L=fluid.layers,
                          cf=fluid.layers.control_flow, opt=fluid.optimizer,
                          un=jun)
T = types.SimpleNamespace(fw=tfw, L=tlayers, cf=tcf, opt=topt, un=tun)


def run_j(main, startup, feeds, fetch, scope=None):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = scope or fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return [[np.asarray(v) for v in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]


def run_t(main, startup, feeds, fetch, exe=None):
    exe = exe or Executor(tfw.CPUPlace())
    scope = Scope()
    exe.run(startup, scope=scope)
    return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


def build(m, make):
    main, startup = m.fw.Program(), m.fw.Program()
    with m.un.guard(), m.fw.program_guard(main, startup):
        feeds, fetch = make(m)
    return main, startup, feeds, fetch


# -- the reference's programs ---------------------------------------------------


def while_concrete_counter(m):
    L = m.L
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=10)
    total = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    x = L.data("x", shape=[10], append_batch_size=False)
    cond = L.less_than(i, limit)
    with L.While(cond).block():
        L.assign(L.elementwise_add(total, L.gather(x, i)), total)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, limit, cond=cond)
    return [{"x": np.arange(10).astype("float32")}], [total, i]


def while_traced_condition(m):
    L = m.L
    n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
    i = L.zeros(shape=[1], dtype="int64")
    i = L.elementwise_add(i, L.zeros(shape=[1], dtype="int64"))
    acc = L.data("acc0", shape=[1], append_batch_size=False)
    cond = L.less_than(i, n)
    with L.While(cond).block():
        L.assign(L.elementwise_add(acc, acc), acc)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=cond)
    return [{"n": np.array([k], "int64"), "acc0": np.array([1.0], "float32")}
            for k in (5, 0, 3)], [acc, i]


def array_write_read_length(m):
    L, cf = m.L, m.cf
    x = L.data("x", shape=[3], append_batch_size=False)
    i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
    i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
    arr = cf.array_write(x, i0)
    cf.array_write(L.elementwise_add(x, x), i1, array=arr)
    return [{"x": np.array([1.0, 2.0, 3.0], "float32")}], [
        cf.array_length(arr), cf.array_read(arr, i0), cf.array_read(arr, i1),
        cf.is_empty(arr)]


def switch_concrete(m):
    L = m.L
    lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    step = L.fill_constant(shape=[1], dtype="float32", value=7.0)
    boundary = L.fill_constant(shape=[1], dtype="float32", value=5.0)
    sw = L.Switch()
    with sw.case(L.less_than(step, boundary)):
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.1), lr)
    with sw.default():
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.01), lr)
    return [{}], [lr]


def conditional_block_traced_pred(m):
    L = m.L
    x = L.data("x", shape=[4], append_batch_size=False)
    flag = L.data("flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    out = L.fill_constant(shape=[4], dtype="float32", value=-1.0)
    out = L.elementwise_add(out, L.zeros([4], "float32"))
    pred = L.greater_than(flag, L.zeros([1], "float32"))
    sw = L.Switch()
    with sw.case(pred):
        L.assign(L.elementwise_mul(x, x), out)
    xs = np.array([1, 2, 3, 4], "float32")
    return [{"x": xs, "flag": np.array([f], "float32")}
            for f in (1.0, -1.0)], [out]


def static_rnn_forward(m):
    L = m.L
    T_, B, D = 5, 2, 3
    x = L.data("x", shape=[T_, B, D], append_batch_size=False)
    h0 = L.data("h0", shape=[B, D], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        h = L.elementwise_add(x_t, h_prev)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    xs = np.random.RandomState(0).randn(T_, B, D).astype("float32")
    return [{"x": xs, "h0": np.zeros((B, D), "float32")}], [rnn()]


def ifelse_merge(m):
    L = m.L
    a = L.data("a", shape=[1], append_batch_size=False)
    b = L.data("b", shape=[1], append_batch_size=False)
    ie = L.IfElse(L.less_than(a, b))
    with ie.true_block():
        ie.output(L.elementwise_add(a, b))
    with ie.false_block():
        ie.output(L.elementwise_sub(a, b))
    out, = ie()
    return [{"a": np.array([x], "float32"), "b": np.array([2.0], "float32")}
            for x in (1.0, 5.0)], [out]


def ifelse_concrete_pred(m):
    L = m.L
    a = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    b = L.fill_constant(shape=[1], dtype="float32", value=2.0)
    ie = L.IfElse(L.less_than(a, b))
    with ie.true_block():
        ie.output(L.elementwise_add(a, b))
    with ie.false_block():
        ie.output(L.elementwise_sub(a, b))
    out, = ie()
    return [{}], [L.scale(out, scale=1.0)]


def cond_two_branches(m):
    L = m.L
    a = L.data("a", shape=[2], append_batch_size=False)
    pred = L.less_than(L.reduce_sum(a), L.fill_constant([1], "float32", 0.0))
    out = L.cond(pred, lambda: L.scale(a, scale=-1.0),
                 lambda: L.elementwise_mul(a, a))
    return [{"a": np.array(v, "float32")} for v in ([1.0, 2.0],
                                                    [-3.0, 1.0])], [out]


def _greedy_decode(m, V, start, eos, max_len, reads=True):
    """tests/test_dynamic_array_while.py's decode: the transitions are a
    feed, so the loop's condition is data-dependent after its first
    iteration."""
    L, cf = m.L, m.cf
    tr = L.data("tr", shape=[V, V], dtype="float32", append_batch_size=False)
    tok = L.assign(np.array([start], "int64"))
    i = L.fill_constant([1], "int64", 0)
    going = L.assign(np.array([True]))
    arr = cf.create_array("int64")
    arr = cf.array_write(tok, i, array=arr)
    with cf.While(cond=going).block():
        cf.increment(i, value=1, in_place=True)
        row = L.gather(tr, tok)
        nxt = L.cast(L.reshape(L.argmax(row, axis=-1), [1]), "int64")
        L.assign(nxt, output=tok)
        cf.array_write(nxt, i, array=arr)
        keep = L.logical_and(
            L.not_equal(nxt, L.fill_constant([1], "int64", eos)),
            L.less_than(i, L.fill_constant([1], "int64", max_len - 1)))
        L.assign(keep, output=going)
    fetch = [cf.array_length(arr)]
    if reads:
        fetch += [cf.array_read(arr, L.fill_constant([1], "int64", k))
                  for k in range(max_len)]
    return fetch


def dynamic_eos_terminates_early(m):
    rng = np.random.RandomState(0)
    trans = rng.rand(12, 12).astype("float32")
    for a, b in ((3, 7), (7, 5), (5, 0)):
        trans[a] = 0
        trans[a, b] = 1
    return [{"tr": trans}], _greedy_decode(m, 12, 3, 0, 10)


def dynamic_max_len_bound_hits(m):
    rng = np.random.RandomState(1)
    trans = rng.rand(8, 8).astype("float32")
    trans[1] = 0
    trans[1, 2] = 1
    trans[2] = 0
    trans[2, 1] = 1
    return [{"tr": trans}], _greedy_decode(m, 8, 1, 0, 6)


def dynamic_length_varies_with_feed(m):
    short = np.zeros((6, 6), "float32")
    short[1, 0] = 1
    long = np.zeros((6, 6), "float32")
    long[1, 2] = long[2, 3] = long[3, 0] = 1
    return [{"tr": short}, {"tr": long}], _greedy_decode(m, 6, 1, 0, 6,
                                                         reads=False)


PROGRAMS = {f.__name__: f for f in (
    while_concrete_counter, while_traced_condition, array_write_read_length,
    switch_concrete, conditional_block_traced_pred, static_rnn_forward,
    ifelse_merge, ifelse_concrete_pred, cond_two_branches,
    dynamic_eos_terminates_early, dynamic_max_len_bound_hits,
    dynamic_length_varies_with_feed)}

# what each program's fetches must show besides agreeing with the reference
EXPECT = {
    "while_concrete_counter": [[45.0, 10]],
    "while_traced_condition": [[32.0, 5], [1.0, 0], [8.0, 3]],
    "switch_concrete": [[0.01]],
    "conditional_block_traced_pred": [[[1, 4, 9, 16]], [[-1, -1, -1, -1]]],
    "ifelse_merge": [[3.0], [3.0]],
    "ifelse_concrete_pred": [[3.0]],
    "cond_two_branches": [[[1.0, 4.0]], [[3.0, -1.0]]],
    "dynamic_eos_terminates_early": [[4, 3, 7, 5, 0] + [0] * 6],
    "dynamic_length_varies_with_feed": [[2], [4]],
}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape or got.size == want.size, (got, want)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=RTOL,
                                   atol=0)
    else:
        assert (got.reshape(want.shape) == want).all(), (got, want)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_reference_program_runs_as_the_reference(name):
    jm, js, feeds, jf = build(J, PROGRAMS[name])
    tm, ts, _feeds, tf = build(T, PROGRAMS[name])
    assert tm.to_dict() == jm.to_dict()
    assert tm.clone(for_test=True).to_dict() == \
        tfw.Program.from_dict(tm.to_dict()).clone(for_test=True).to_dict()
    want = run_j(jm, js, feeds, jf)
    got = run_t(tm, ts, feeds, tf)
    for g_run, w_run in zip(got, want):
        for g, w in zip(g_run, w_run):
            _close(g, w)
    if name in EXPECT:
        for g_run, e_run in zip(got, EXPECT[name]):
            for g, e in zip(g_run, e_run):
                assert np.allclose(np.asarray(g).ravel(), np.ravel(e)), \
                    (name, g, e)


def test_sub_blocks_round_trip_through_the_dict():
    tm, _ts, _f, _fetch = build(T, dynamic_eos_terminates_early)
    d = tm.to_dict()
    assert [b["parent_idx"] for b in d["blocks"]] == [-1, 0]
    back = tfw.Program.from_dict(d)
    assert back.to_dict() == d
    while_op, = [op for op in back.global_block().ops if op.type == "while"]
    assert while_op.attr("sub_block") == 1
    assert back.block(1).parent_block is back.global_block()
    test_p = tm.clone(for_test=True)
    assert [b.parent_idx for b in test_p.blocks] == [-1, 0]


def _rnn_trains(m):
    T_, B, D, H = 4, 8, 3, 5
    L = m.L
    x = L.data("x", shape=[T_, B, D], append_batch_size=False)
    y = L.data("y", shape=[B, 1], append_batch_size=False)
    h0 = L.fill_constant(shape=[B, H], dtype="float32", value=0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        z = L.fc(input=x_t, size=H, act=None, name="rnn_fc")
        h = L.tanh(L.elementwise_add(z, h_prev))
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()
    last = L.reshape(L.slice(out, axes=[0], starts=[T_ - 1], ends=[T_]),
                     [B, H])
    pred = L.fc(input=last, size=1, act=None)
    loss = L.reduce_mean(L.square(pred - y))
    m.opt.SGDOptimizer(learning_rate=0.1).minimize(loss)
    rng = np.random.RandomState(1)
    return [{"x": rng.randn(T_, B, D).astype("float32"),
             "y": rng.randn(B, 1).astype("float32")}], [loss]


def test_static_rnn_trains_as_the_reference():
    """The recurrent op's gradient (the registry's vjp replay through the
    sub-block) against the reference's (a vjp through lax.scan): 15 SGD
    steps from the reference's initial state."""
    jm, js, feeds, jloss = build(J, _rnn_trains)
    tm, _ts, _f, tloss = build(T, _rnn_trains)
    assert tm.to_dict() == jm.to_dict()
    assert "recurrent_grad" in [op.type for op in tm.global_block().ops]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {v.name: np.array(scope.find_var(v.name).get_tensor().numpy())
                for v in jm.list_vars() if v.persistable and not v.is_data}
        want = [float(np.asarray(exe.run(jm, feed=feeds[0],
                                         fetch_list=jloss)[0]).ravel()[0])
                for _ in range(15)]
    texe = Executor(tfw.CPUPlace())
    sc = scope_from_numpy(Scope(), init, "cpu", program=tm)
    got = [float(texe.run(tm, feed=feeds[0], fetch_list=tloss,
                          scope=sc)[0].ravel()[0]) for _ in range(15)]
    np.testing.assert_allclose(got, want, rtol=RNN_LOSS_RTOL)
    assert got[-1] < got[0] * 0.7


# -- the two forms ---------------------------------------------------------------


def _carried_array(m, read_at, write_at=None):
    """An array the data-dependent greedy decode carries (so bounded), read
    at ``read_at`` and, with ``write_at``, written there after the loop
    at a constant index."""
    trans = np.zeros((6, 6), "float32")
    trans[1, 2] = trans[2, 0] = 1
    L, cf = m.L, m.cf
    fetch = _greedy_decode(m, 6, 1, 0, 6, reads=False)
    arr = m.fw.default_main_program().global_block().vars[
        [op for op in m.fw.default_main_program().global_block().ops
         if op.type == "lod_array_length"][0].input("X")[0]]
    if write_at is not None:
        cf.array_write(L.fill_constant([1], "int64", 9),
                       L.fill_constant([1], "int64", write_at), array=arr)
    fetch.append(cf.array_read(arr, L.fill_constant([1], "int64", read_at)))
    return [{"tr": trans}], fetch


def _list_array(m, read_at):
    L, cf = m.L, m.cf
    x = L.data("x", shape=[2], append_batch_size=False)
    arr = cf.array_write(x, L.fill_constant([1], "int64", 0))
    return [{"x": np.ones(2, "float32")}], [
        cf.array_length(arr),
        cf.array_read(arr, L.fill_constant([1], "int64", read_at))]


def test_read_past_the_end_bounded_gives_zeros():
    """Bounded (carried by a data-dependent while): a read past the length
    gives the buffer's zeros, as the reference's; the length is int64."""
    make = lambda m: _carried_array(m, read_at=5)  # noqa: E731
    jm, js, feeds, jf = build(J, make)
    tm, ts, _f, tf = build(T, make)
    assert tm.to_dict() == jm.to_dict()
    (jn, jr), = run_j(jm, js, feeds, jf)
    (tn, tr), = run_t(tm, ts, feeds, tf)
    assert int(tn) == int(jn) == 3 and tn.dtype == np.int64
    assert int(tr.ravel()[0]) == int(jr.ravel()[0]) == 0


def test_read_past_the_end_list_raises():
    """List (constant indices, no loop): a read past the end raises an
    IndexError in both packages; the length is int64."""
    make = lambda m: _list_array(m, read_at=1)  # noqa: E731
    jm, js, feeds, jf = build(J, make)
    tm, ts, _f, tf = build(T, make)
    assert tm.to_dict() == jm.to_dict()
    with pytest.raises(IndexError):
        run_j(jm, js, feeds, jf)
    with pytest.raises(IndexError):
        run_t(tm, ts, feeds, tf)
    ok = lambda m: _list_array(m, read_at=0)  # noqa: E731
    jm, js, feeds, jf = build(J, ok)
    tm, ts, _f, tf = build(T, ok)
    (jn, jr), = run_j(jm, js, feeds, jf)
    (tn, tr), = run_t(tm, ts, feeds, tf)
    assert int(tn) == int(jn) == 1 and tn.dtype == np.int64
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("write_at, raises", [(255, False), (256, True)])
def test_bounded_capacity_checked_at_a_constant_index(write_at, raises):
    """A write at a constant index into a bounded array is checked against
    FLAGS_tensor_array_max_len (256): the last slot takes it, the next
    raises, in both packages."""
    make = lambda m: _carried_array(m, read_at=write_at,  # noqa: E731
                                    write_at=write_at)
    jm, js, feeds, jf = build(J, make)
    tm, ts, _f, tf = build(T, make)
    assert tm.to_dict() == jm.to_dict()
    if raises:
        with pytest.raises(ValueError, match="capacity"):
            run_j(jm, js, feeds, jf)
        with pytest.raises(ValueError, match="capacity"):
            run_t(tm, ts, feeds, tf)
        return
    (jn, jr), = run_j(jm, js, feeds, jf)
    (tn, tr), = run_t(tm, ts, feeds, tf)
    # the length is read before the write
    assert int(tn) == int(jn) == 3 and int(tr) == int(jr) == 9


def test_bounded_capacity_follows_the_flag():
    tflags.set_flags({"FLAGS_tensor_array_max_len": 8})
    try:
        tm, ts, feeds, tf = build(T, lambda m: _carried_array(m, 8, 8))
        with pytest.raises(ValueError, match="capacity 8"):
            run_t(tm, ts, feeds, tf)
    finally:
        tflags.set_flags({"FLAGS_tensor_array_max_len": 256})


def _branch_creates(m, pred_of, reads_feed):
    """A false branch that creates a var, fetched after it; its predicate
    derived from a feed or a constant of the program, its body reading a
    feed or only a constant it makes."""
    L = m.L
    x = L.data("x", shape=[3], append_batch_size=False)
    if pred_of == "feed":
        pred = L.greater_than(L.reduce_sum(x), L.fill_constant([1], "float32",
                                                               100.0))
    else:
        pred = L.less_than(L.fill_constant([1], "float32", 1.0),
                           L.fill_constant([1], "float32", 0.0))
    made = []
    sw = L.Switch()
    with sw.case(pred):
        src = x if reads_feed else L.fill_constant([3], "float32", 1.0)
        made.append(L.scale(src, scale=2.0))
    return [{"x": np.array([1.0, 2.0, 3.0], "float32")}], made


@pytest.mark.parametrize("pred_of, reads_feed, data_dependent", [
    ("feed", True, True), ("feed", False, True), ("constant", True, True),
    ("constant", False, False)])
def test_a_skipped_branch_var(pred_of, reads_feed, data_dependent):
    """A branch is data-dependent when its predicate or a var its body
    reads is.  Skipped so, its new var comes out as zeros of its shape
    (the reference's lax.cond default); skipped under a constant predicate
    with a body of constants, it is absent, and fetching it fails in
    both."""
    make = lambda m: _branch_creates(m, pred_of, reads_feed)  # noqa: E731
    jm, js, feeds, jf = build(J, make)
    tm, ts, _f, tf = build(T, make)
    assert tm.to_dict() == jm.to_dict()
    if data_dependent:
        (jv,), = run_j(jm, js, feeds, jf)
        (tv,), = run_t(tm, ts, feeds, tf)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tv, np.zeros(3, "float32"))
        return
    with pytest.raises(Exception):
        run_j(jm, js, feeds, jf)
    with pytest.raises(KeyError, match="never produced"):
        run_t(tm, ts, feeds, tf)


def test_host_syncs_a_step():
    """One host sync a loop-condition read (10 true, 1 false) and one a
    constant list index; none where a branch has no ops."""
    tm, ts, feeds, tf = build(T, while_concrete_counter)
    exe = Executor(tfw.CPUPlace())
    run_t(tm, ts, feeds, tf, exe=exe)
    assert exe.last_host_syncs == 11
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[1], append_batch_size=False)
        sw = tlayers.Switch()
        with sw.case(tlayers.greater_than(x, x)):
            pass
        out = tlayers.scale(x, scale=3.0)
    run_t(main, startup, [{"x": np.ones(1, "float32")}], [out], exe=exe)
    assert exe.last_host_syncs == 0


# -- the small ops ----------------------------------------------------------------


def _op_cases():
    rng = np.random.RandomState(0)
    a = rng.rand(4, 5) > 0.5
    b = rng.rand(4, 5) > 0.5
    x = rng.randn(4, 5).astype("float32")
    return [
        ("logical_not", [a], {}),
        ("logical_or", [a, b], {}),
        ("logical_xor", [a, b], {}),
        ("logical_and", [a, b], {}),
        ("arg_max", [x], {"axis": 1}),
        ("arg_min", [x], {"axis": 0}),
        ("arg_max", [x], {"axis": 0, "flatten": True}),
        ("arg_min", [x], {"axis": -1, "keepdims": True}),
        ("reduce_mean", [x], {"dim": [1], "keep_dim": False,
                              "reduce_all": False}),
        ("reduce_mean", [x], {"dim": [0], "keep_dim": True,
                              "reduce_all": True}),
        ("tanh", [x], {}),
        ("sigmoid", [x], {}),
        ("square", [x], {}),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_small_op_matches_the_reference(case):
    name, args, attrs = _op_cases()[case]
    j = jreg.get_op_def(name).lower(JCtx(), *args, **attrs)
    t = treg.get_op_def(name).lower(TCtx(torch.device("cpu")),
                                    *[torch.from_numpy(np.array(a))
                                      for a in args], **attrs)
    j, t = np.asarray(j), t.numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    else:
        assert t.dtype == (np.int64 if name.startswith("arg") else j.dtype)
        assert (t == j).all()


def test_ops_and_layers_are_registered_and_exported():
    for t in ("while", "conditional_block", "read_from_array",
              "lod_array_length", "is_empty", "print", "recurrent",
              "logical_not", "logical_or", "logical_xor", "arg_max",
              "arg_min", "write_to_array"):
        assert t in treg.all_op_types(), t
    assert sorted(tcf.__all__) == sorted(fluid.layers.control_flow.__all__)
    for name in ("While", "Switch", "IfElse", "cond", "StaticRNN",
                 "array_read", "array_length", "is_empty", "Print",
                 "argmax", "argmin", "logical_not", "logical_or"):
        assert hasattr(tlayers, name), name


def test_print_passes_through_and_prints(capsys):
    def make(m):
        x = m.L.data("x", shape=[3], append_batch_size=False)
        return [{"x": np.arange(3).astype("float32")}] * 3, [
            m.L.scale(m.L.Print(x, message="seen", first_n=2), scale=2.0)]

    jm, _js, feeds, _jf = build(J, make)
    tm, ts, _f, tf = build(T, make)
    assert tm.to_dict() == jm.to_dict()
    exe = Executor(tfw.CPUPlace())
    got = run_t(tm, ts, feeds, tf, exe=exe)
    np.testing.assert_array_equal(got[0][0], [0.0, 2.0, 4.0])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("seen")]
    assert len(lines) == 2 and "(3,)" in lines[0] and "[0. 1. 2.]" in lines[0]
    assert exe.last_host_syncs == 0


def test_sub_block_ops_draw_from_the_five_part_seed():
    """A dropout in a loop body draws from SeedSequence([program seed,
    step, the while op's index, the iteration, its own index]): each
    iteration its own mask, the one a direct call with that seed gives."""
    from paddle_tpu_torch.core.lowering import op_seed, path_seed
    from paddle_tpu_torch.core.registry import lower_attrs

    main, startup = tfw.Program(), tfw.Program()
    main.random_seed = 7
    with tun.guard(), tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[256], append_batch_size=False)
        i = tlayers.fill_constant([1], "int64", 0)
        n = tlayers.fill_constant([1], "int64", 2)
        arr = tlayers.create_array("float32")
        cond = tlayers.less_than(i, n)
        with tlayers.While(cond).block():
            tlayers.array_write(tlayers.dropout(x, 0.5), i, array=arr)
            tlayers.increment(i, value=1, in_place=True)
            tlayers.less_than(i, n, cond=cond)
        outs = [tlayers.array_read(arr, tlayers.fill_constant([1], "int64",
                                                              k))
                for k in range(2)]
    exe, scope = Executor(tfw.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    step = scope._rng_counter
    xs = np.ones(256, "float32")
    got = exe.run(main, feed={"x": xs}, fetch_list=outs, scope=scope)
    w = [k for k, op in enumerate(main.global_block().ops)
         if op.type == "while"][0]
    j, drop = [(k, op) for k, op in enumerate(main.block(1).ops)
               if op.type == "dropout"][0]
    opdef = treg.get_op_def("dropout")
    for it, g in enumerate(got):
        seed = path_seed(7, step, (w, it, j))
        want, _mask = opdef.lower(TCtx(torch.device("cpu"), drop, seed),
                                  torch.from_numpy(xs),
                                  **lower_attrs(drop.attrs))
        np.testing.assert_array_equal(g, want.numpy())
    assert not np.array_equal(got[0], got[1])
    assert path_seed(7, 3, (5,)) == op_seed(7, 3, 5)
