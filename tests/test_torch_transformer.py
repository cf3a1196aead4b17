"""The Transformer NMT slice of the PyTorch port held against the JAX
package on the CPU.

* Ops: each op type the slice adds (``assign_value``,
  ``fill_constant_batch_size_like``, ``pow``, ``reduce_sum`` and its grad,
  ``increment``, ``one_hot``, ``label_smooth``, ``log_softmax``,
  ``expand``, ``slice``, ``write_to_array``, ``beam_search``,
  ``beam_search_decode``) and ``elementwise_add`` at the beam decoder's
  ``axis=0`` broadcast, the port's lowering against the reference's on
  seeded inputs.  Floats agree to 1e-6 (the same f32 arithmetic); ids by
  value (the reference runs without x64, so its int64 comes back int32).
  ``one_hot`` squeezes a trailing dim of 1 and otherwise appends depth;
  ``beam_search`` gives the reference's golden case
  (``tests/test_transformer.py``).
* Programs: ``build_train`` and ``build_beam_infer`` of
  ``TRANSFORMER_TINY`` (the reference's bundled ``transformer_tiny``)
  equal the reference's through ``to_dict()``: op types in order, attrs,
  variables, parameter names and shapes, the startup programs too.
* Training: from the reference's initial state (``scope_from_numpy``),
  ``TRANSFORMER_TINY`` takes 5 steps of one padded batch in each package,
  at dropout 0 and at dropout 0.1 with both packages' dropout draws
  patched to one mask: losses to 1e-4 (f32 in another summation order),
  each Adam moment tensor to 5e-3 of its largest element (with
  ``test_torch_bert_train.py``'s floor), and each step's noam learning
  rate, fetched from both, to 1e-6 relative of each other and of the
  formula: the step counter's one increment runs once a step, before the
  schedule, in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import nn as jnn
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                   scope_to_numpy)
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.utils import unique_name as tun

OP_ATOL = 1e-6
LOSS_ATOL = 1e-4
MOMENT_RTOL = 5e-3
MOMENT_FLOOR = 1e-4
LR_RTOL = 1e-6
STEPS = 5
SRC, TRG = 8, 8

NEW_TYPES = ("assign_value", "fill_constant_batch_size_like", "pow",
             "reduce_sum", "reduce_sum_grad", "increment", "one_hot",
             "label_smooth", "log_softmax", "expand", "slice",
             "write_to_array", "beam_search", "beam_search_decode")


def _jax(op_type, args, attrs):
    out = jreg.get_op_def(op_type).lower(
        JCtx(mode="eager"),
        *[None if a is None else jnp.asarray(a) for a in args], **attrs)
    return out if isinstance(out, tuple) else (out,)


def _port(op_type, args, attrs):
    out = treg.get_op_def(op_type).lower(
        TCtx(torch.device("cpu")),
        *[None if a is None else torch.from_numpy(np.array(a))
          for a in args], **attrs)
    return out if isinstance(out, tuple) else (out,)


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=OP_ATOL, rtol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _ids(rng, high, *shape):
    return rng.randint(0, high, shape).astype(np.int64)


def _cases():
    rng = np.random.RandomState(0)
    x3 = _rand(rng, 3, 4, 5)
    ints = _ids(rng, 7, 3, 5)
    ints[0, 0] = 9                       # out of range: a row of zeros
    return [
        ("assign_value", [], {"shape": [2, 3], "dtype": 5,
                              "fp32_values": [float(v) for v in
                                              _rand(rng, 6)]}),
        ("assign_value", [], {"shape": [1, 4], "dtype": 2,
                              "int32_values": [3, -1, 0, 7]}),
        ("assign_value", [], {"shape": [3], "dtype": 3,
                              "int64_values": [5, 1, 2]}),
        ("fill_constant_batch_size_like", [_ids(rng, 9, 5, 7)],
         {"shape": [-1, 4], "dtype": 3, "value": 1.0}),
        ("fill_constant_batch_size_like", [_rand(rng, 2, 6)],
         {"shape": [3, -1], "dtype": 5, "value": -2.5, "input_dim_idx": 1,
          "output_dim_idx": 1}),
        ("pow", [np.abs(_rand(rng, 4, 5)) + 0.1], {"factor": -0.5}),
        ("reduce_sum", [x3], {"dim": [0], "keep_dim": False,
                              "reduce_all": True}),
        ("reduce_sum", [x3], {"dim": [1], "keep_dim": False,
                              "reduce_all": False}),
        ("reduce_sum", [x3], {"dim": [-1, 0], "keep_dim": True,
                              "reduce_all": False}),
        ("reduce_sum_grad", [x3, np.zeros([1], np.float32),
                             _rand(rng, 1)],
         {"dim": [0], "keep_dim": False, "reduce_all": True}),
        ("reduce_sum_grad", [x3, np.zeros([3, 5], np.float32),
                             _rand(rng, 3, 5)],
         {"dim": [1], "keep_dim": False, "reduce_all": False}),
        ("reduce_sum_grad", [x3, np.zeros([1, 4, 1], np.float32),
                             _rand(rng, 1, 4, 1)],
         {"dim": [-1, 0], "keep_dim": True, "reduce_all": False}),
        ("increment", [np.array([4.0], np.float32)], {"step": 1.0}),
        ("increment", [np.array([2], np.int64)], {"step": 3.0}),
        ("one_hot", [ints, None], {"depth": 7}),                 # [B, T]
        ("one_hot", [ints[..., None], None], {"depth": 7}),      # squeezed
        ("one_hot", [_ids(rng, 4, 3, 4), None], {"depth": 4}),   # [B, K]
        ("label_smooth", [np.eye(6, dtype=np.float32)[None], None],
         {"epsilon": 0.1}),
        ("label_smooth", [np.eye(6, dtype=np.float32)[None],
                          np.abs(_rand(rng, 1, 6))], {"epsilon": 0.2}),
        ("log_softmax", [_rand(rng, 2, 3, 7)], {"axis": -1}),
        ("log_softmax", [_rand(rng, 2, 3, 7)], {"axis": 1}),
        ("expand", [_rand(rng, 2, 1, 3), None],
         {"expand_times": [1, 4, 1]}),
        ("expand", [_rand(rng, 2, 1, 1, 5), None],
         {"expand_times": [1, 3, 1, 1]}),
        ("slice", [x3, None, None], {"axes": [1], "starts": [2],
                                     "ends": [3]}),
        ("slice", [x3, None, None], {"axes": [0, 2], "starts": [-2, 1],
                                     "ends": [10, -1]}),
        ("slice", [x3, None, None], {"axes": [1], "starts": [1],
                                     "ends": [2], "decrease_axis": [1]}),
        ("elementwise_add", [_rand(rng, 3, 4, 9), _rand(rng, 3, 4)],
         {"axis": 0}),
    ]


@pytest.mark.parametrize("case", range(len(_cases())),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_cases())])
def test_op_matches_reference(case):
    op_type, args, attrs = _cases()[case]
    want = _jax(op_type, args, attrs)
    got = _port(op_type, args, attrs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g.numpy(), w, "%s output %d" % (op_type, i))


def test_every_new_op_type_is_registered():
    assert set(NEW_TYPES) <= set(treg.all_op_types())
    assert set(NEW_TYPES) - {"reduce_sum_grad"} <= set(jreg.all_op_types())


def test_one_hot_shape_rule():
    ids = torch.tensor([[1], [3]])
    assert tuple(_port("one_hot", [ids.numpy(), None],
                       {"depth": 5})[0].shape) == (2, 5)
    pk = torch.tensor([[0, 2, 1, 3]] * 3)                    # [B, K]
    out = _port("one_hot", [pk.numpy(), None], {"depth": 4})[0]
    assert tuple(out.shape) == (3, 4, 4)
    assert torch.equal(out.argmax(-1), pk)


def test_write_to_array_grows_a_list():
    """Writes at 0 and 2: a list of 3, its middle entry None, in both."""
    jw = jreg.get_op_def("write_to_array").lower
    tw = treg.get_op_def("write_to_array").lower
    want = got = None
    for i in (0, 2):
        x = np.full([2, 3], float(i), np.float32)
        want = jw(JCtx(mode="eager"), jnp.asarray(x),
                  jnp.asarray([i]), want)[0]
        got = tw(TCtx(torch.device("cpu")), torch.from_numpy(x),
                 torch.tensor([i]), got)[0]
    assert len(got) == len(want) == 3 and got[1] is None and want[1] is None
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        _same(g.numpy(), w, "array entry")


def _beam_step(pre_ids, pre_scores, acc, k, end_id=1):
    args = [pre_ids, pre_scores, None, acc]
    attrs = {"beam_size": k, "end_id": end_id}
    return _jax("beam_search", args, attrs), _port("beam_search", args,
                                                    attrs)


def test_beam_search_golden_case():
    """The reference's hand-computed case: beam 0 alive at -1, beam 1
    finished at -2 (end_id 1)."""
    pre_ids = np.array([[3, 1]], np.int64)
    pre_scores = np.array([[-1.0, -2.0]], np.float32)
    step = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    acc = pre_scores[..., None] + np.stack([step, step])[None]
    want, got = _beam_step(pre_ids, pre_scores, acc, 2)
    ids, scores, parent = (t.numpy() for t in got)
    assert ids[0, 0] == 3 and parent[0, 0] == 0
    np.testing.assert_allclose(scores[0, 0], -1 + np.log(0.4), rtol=1e-5)
    assert ids[0, 1] == 1 and parent[0, 1] == 1
    np.testing.assert_allclose(scores[0, 1], -2.0, rtol=1e-5)
    for g, w in zip(got, want):
        _same(g.numpy(), w, "beam_search golden")


def test_beam_search_random_step():
    rng = np.random.RandomState(3)
    b, k, v = 5, 4, 11
    pre_ids = _ids(rng, v, b, k)
    pre_ids[1, 2] = pre_ids[3, 0] = 1                   # finished beams
    pre_scores = -np.abs(_rand(rng, b, k))
    acc = pre_scores[..., None] + np.log(
        np.abs(_rand(rng, b, k, v)) + 0.05).astype(np.float32)
    want, got = _beam_step(pre_ids, pre_scores, acc, k)
    for g, w in zip(got, want):
        _same(g.numpy(), w, "beam_search")


def test_beam_search_decode_matches_reference():
    rng = np.random.RandomState(4)
    b, k, t = 3, 4, 6
    ids = [_ids(rng, 9, b, k) for _ in range(t)]
    ids[2][0, 1] = 1                                    # an end_id mid-way
    parents = [_ids(rng, k, b, k) for _ in range(t)]
    scores = _rand(rng, b, k)
    attrs = {"beam_size": k, "end_id": 1}
    want = jreg.get_op_def("beam_search_decode").lower(
        JCtx(mode="eager"), [jnp.asarray(a) for a in ids],
        [jnp.asarray(a) for a in parents], jnp.asarray(scores), **attrs)
    got = treg.get_op_def("beam_search_decode").lower(
        TCtx(torch.device("cpu")), [torch.from_numpy(a) for a in ids],
        [torch.from_numpy(a) for a in parents], torch.from_numpy(scores),
        **attrs)
    for g, w in zip(got, want):
        _same(g.numpy(), w, "beam_search_decode")
    # the reference's backtrack case: step 1 picks parents [1, 0]
    sent, _ = treg.get_op_def("beam_search_decode").lower(
        TCtx(torch.device("cpu")),
        [torch.tensor([[5, 6]]), torch.tensor([[7, 8]])],
        [torch.tensor([[0, 0]]), torch.tensor([[1, 0]])], None, **attrs)
    assert sent.tolist() == [[[6, 7], [5, 8]]]


# -- programs ----------------------------------------------------------------


def tiny(mod, dropout=0.1):
    """The reference's bundled transformer_tiny, at ``dropout``."""
    return mod.TransformerConfig(
        src_vocab=64, trg_vocab=64, d_model=32, heads=2, enc_layers=1,
        dec_layers=1, ffn=64, max_len=16, dropout=dropout)


def programs(mod, fw, un, build):
    main, startup = fw.Program(), fw.Program()
    with un.guard(), fw.program_guard(main, startup):
        out = build(mod)
    return main, startup, out


def _train(mod, dropout=0.1):
    return mod.build_train(tiny(mod, dropout), SRC, TRG)[1]


def _beam(mod):
    return mod.build_beam_infer(tiny(mod), SRC, beam_size=3, max_out_len=5)


@pytest.mark.parametrize("build", [_train, _beam], ids=["train", "beam"])
def test_programs_equal_reference(build):
    for k in ("src_vocab", "trg_vocab", "d_model", "heads", "enc_layers",
              "dec_layers", "ffn", "max_len", "dropout", "label_smooth"):
        assert getattr(ttr.TRANSFORMER_TINY, k) == getattr(tiny(ttr), k)
    jm, js, _ = programs(jtr, fluid, jun, build)
    tm, ts, _ = programs(ttr, tfw, tun, build)
    assert [op.type for op in tm.global_block().ops] \
        == [op.type for op in jm.global_block().ops]
    params = {v.name: tuple(v.shape) for v in tm.list_vars()
              if isinstance(v, tfw.Parameter)}
    assert params == {v.name: tuple(v.shape) for v in jm.list_vars()
                      if isinstance(v, fluid.framework.Parameter)}
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    types = {op.type for op in tm.global_block().ops}
    assert "flash_attention" not in types       # attention stays composed
    if build is _train:
        ops = tm.global_block().ops
        inc = [i for i, op in enumerate(ops) if op.type == "increment"]
        assert len(inc) == 1
        assert ops[inc[0]].attr("op_role") == tfw.OpRole.LRSched
        assert ops[inc[0]].output("Out") == ["@LR_DECAY_COUNTER@"]
        adam = [i for i, op in enumerate(ops) if op.type == "adam"]
        assert inc[0] < min(adam)
    else:
        assert sum(t == "beam_search" for t in
                   [op.type for op in tm.global_block().ops]) == 5


def test_unported_loops_raise_by_name():
    """The loops the beam decoder once had to unroll are ported: ``While``
    and ``cond`` build the reference's ``while`` and ``conditional_block``
    programs (``tests/test_torch_control_flow.py`` runs them)."""
    from paddle_tpu_torch import layers

    def build(pkg, L, un):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard(), pkg.program_guard(main, startup):
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            c = L.less_than(i, n)
            with L.While(c).block():
                L.increment(i, value=1, in_place=True)
                L.less_than(i, n, cond=c)
            L.cond(c, lambda: L.scale(i, scale=2.0),
                   lambda: L.scale(i, scale=3.0))
        return main.to_dict()

    got = build(tfw, layers, tun)
    assert got == build(fluid, fluid.layers, jun)
    assert [op["type"] for op in got["blocks"][0]["ops"]].count(
        "conditional_block") == 2
    assert "while" in [op["type"] for op in got["blocks"][0]["ops"]]


# -- training ----------------------------------------------------------------


def _hash_keep(shape, thr):
    """Keep iff hash(element index) < thr (a u32 threshold): a fixed
    function of the shape and the index (as test_torch_bert_dropout.py)."""
    n = int(np.prod(shape))
    h = (np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B1)
         + np.uint64(0x7F4A7C15)) & np.uint64(0xFFFFFFFF)
    return (h < np.uint64(thr)).reshape(tuple(int(d) for d in shape))


def patch_masks(monkeypatch):
    """Both packages' dropout-op draws -> _hash_keep at the byte draw's
    threshold."""
    jax_bytes0 = jnn.bernoulli_bytes

    def jax_bytes(key, keep_prob, shape):
        if not all(isinstance(d, (int, np.integer)) for d in shape):
            return jax_bytes0(key, keep_prob, shape)   # build-time shapes
        thr8 = min(max(int(round(float(keep_prob) * 256.0)), 0), 256)
        return _hash_keep(shape, thr8 << 24)

    monkeypatch.setattr(jnn, "bernoulli_bytes", jax_bytes)
    monkeypatch.setattr(
        philox, "keep_bytes",
        lambda seed, thr, shape, device="cpu": torch.from_numpy(
            _hash_keep(shape, thr << 24)).to(device))


def feed(seed=0, batch=6):
    """Padded pairs: sources of 3-8 tokens (EOS after), targets of 2-8."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(batch):
        s = rng.randint(3, 64, rng.randint(3, SRC + 1))
        t = rng.randint(3, 64, rng.randint(2, TRG + 1))
        samples.append((s, [ttr.BOS] + list(t[:-1]), list(t)))
    src, trg, nxt, w = ttr.pad_batch(samples, SRC, TRG)
    return {"src_ids": src, "trg_ids": trg, "trg_next": nxt,
            "trg_weight": w}


def lr_name(main):
    return next(op.input("LearningRate")[0]
                for op in main.global_block().ops if op.type == "adam")


def noam(step, cfg, warmup=400):
    return cfg.d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_transformer_tiny_trains_as_the_reference(monkeypatch, dropout):
    if dropout:
        patch_masks(monkeypatch)
    build = lambda mod: _train(mod, dropout)  # noqa: E731
    jm, js, jloss = programs(jtr, fluid, jun, build)
    tm, _ts, tloss = programs(ttr, tfw, tun, build)
    jlr, tlr = lr_name(jm), lr_name(tm)
    f = feed()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars()
             if v.persistable and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}
        want = [exe.run(jm, feed=f, fetch_list=[jloss, jlr])
                for _ in range(STEPS)]
        want_state = {n: np.array(scope.find_var(n).get_tensor().numpy())
                      for n in names}
    tscope = scope_from_numpy(Scope(), init, "cpu", program=tm)
    texe = Executor(tfw.CPUPlace())
    got = [texe.run(tm, feed=f, fetch_list=[tloss, tlr], scope=tscope)
           for _ in range(STEPS)]
    losses = [float(g[0].ravel()[0]) for g in got]
    np.testing.assert_allclose(
        losses, [float(np.asarray(w[0]).ravel()[0]) for w in want],
        atol=LOSS_ATOL, rtol=0)
    assert losses[-1] < losses[0]
    lrs = [float(g[1].ravel()[0]) for g in got]
    np.testing.assert_allclose(
        lrs, [float(np.asarray(w[1]).ravel()[0]) for w in want],
        rtol=LR_RTOL, atol=0)
    np.testing.assert_allclose(
        lrs, [noam(s + 1, tiny(ttr)) for s in range(STEPS)], rtol=LR_RTOL,
        atol=0)
    final = scope_to_numpy(tscope, tm)
    assert final["@LR_DECAY_COUNTER@"].tolist() \
        == want_state["@LR_DECAY_COUNTER@"].tolist() == [float(STEPS)]
    assert sum(op.type == "fused_adam" for op in tm.global_block().ops) == 1
    moments = [n for n in want_state if "_moment" in n]
    assert len(moments) == 2 * sum(
        isinstance(v, tfw.Parameter) for v in tm.list_vars())
    top = {k: max(np.abs(want_state[n]).max() for n in moments if k in n)
           for k in ("_moment1_", "_moment2_")}
    floor = {"_moment1_": MOMENT_FLOOR * top["_moment1_"],
             "_moment2_": MOMENT_FLOOR ** 2 * top["_moment2_"]}
    for n in moments:
        w = want_state[n]
        kind = "_moment1_" if "_moment1_" in n else "_moment2_"
        scale = max(np.abs(w).max(), floor[kind])
        np.testing.assert_allclose(final[n], w, atol=MOMENT_RTOL * scale,
                                   rtol=0, err_msg=n)
