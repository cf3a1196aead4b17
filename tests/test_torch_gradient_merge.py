"""``GradientMergeOptimizer`` in the port held against the JAX package on
the CPU.

* The MLP of ``tests/test_dist_mnist_subprocess.py:59-101`` under
  Momentum: 4 micro-batches of 4 at k = 2 end where 2 batches of 8 do
  (RTOL 1e-5, ATOL 1e-6 on every weight), in the port, from the
  reference's initial state; the program dicts equal the reference's and
  so do the weights after the merged run.
* The L2Decay Momentum repro (``:135-165``): the decay ops land inside
  the boundary branch with their inputs, and 4 steps give the
  reference's losses.
* BERT_TINY (the ``tests/test_torch_clip.py`` build at dropout 0, seq 16,
  batch 4) under ``GradientMergeOptimizer(Adam, k_steps=2)``: equal
  programs; two windows (4 micro-steps) from the reference's initial
  state give its losses to BERT_LOSS_ATOL and, after each window, its
  parameters, moments and merged buffers to STATE_RTOL of each tensor's
  largest value, at most FLIP_SHARE of the elements beyond (Adam's first
  step divides by |g|, as there).  The two key projections' biases have
  a gradient that is zero but for rounding (softmax ignores a shift
  shared by a row's scores): found as the merged buffers below NOISE of
  the largest, they and their state are held to being finite only, and
  the test checks that these are exactly one bias a layer.  Between
  boundaries the parameters do not move, and after one the buffers are
  zero, bitwise; the step counts one host sync (the boundary's
  predicate; the empty default branch reads nothing).
* The program's shape: the inner optimizer's accumulators and learning
  rate in the global block, its update ops in the branch, whose ``Out``
  lists every persistable they write; the fusion pass leaves them
  unfused; ``k_steps=1`` is the inner optimizer.
"""

import types

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import param_attr as tpa
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.utils import unique_name as tun

MERGE_RTOL, MERGE_ATOL = 1e-5, 1e-6
LOSS_ATOL = 1e-5
BERT_LOSS_ATOL = 1e-4
STATE_RTOL = 1e-4
FLIP_SHARE = 1e-3
BERT_SEQ, BERT_BATCH = 16, 4
NOISE = 1e-6

J = types.SimpleNamespace(fw=fluid, L=fluid.layers, opt=fluid.optimizer,
                          reg=fluid.regularizer, attr=fluid.ParamAttr,
                          un=jun, bert=jbert)
T = types.SimpleNamespace(fw=tfw, L=tlayers, opt=topt, reg=treg,
                          attr=tpa.ParamAttr, un=tun, bert=tbert)


def _persistables(main):
    return [v.name for v in main.list_vars()
            if v.persistable and not v.is_data]


def _reference(jm, js, feeds, fetch):
    """The reference's initial persistables, its fetches a step and its
    persistables after each step."""
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = _persistables(jm)

    def state():
        return {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}

    with fluid.scope_guard(scope):
        exe.run(js)
        init, outs, states = state(), [], []
        for f in feeds:
            outs.append([np.asarray(v) for v in exe.run(jm, feed=f,
                                                        fetch_list=fetch)])
            states.append(state())
    return init, outs, states


def _port(tm, init, feeds, fetch):
    exe = Executor(tfw.CPUPlace())
    sc = scope_from_numpy(Scope(), init, "cpu", program=tm)
    outs, states, syncs = [], [], []
    for f in feeds:
        outs.append(exe.run(tm, feed=f, fetch_list=fetch, scope=sc))
        states.append({n: sc.find_var(n).get_tensor().numpy().copy()
                       for n in init})
        syncs.append(exe.last_host_syncs)
    return outs, states, syncs


def _state_close(got, want, what, noise=()):
    for n, w in want.items():
        g = got[n]
        assert np.isfinite(g).all(), (what, n)
        if n.split("_moment")[0].split(".merged_grad")[0] in noise:
            continue
        d = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
        assert d.max() <= STATE_RTOL or (d > STATE_RTOL).mean() \
            <= FLIP_SHARE, (what, n, float(d.max()))


# -- the MLP: k merged micro-batches against one larger batch ------------------


def mlp(m, merge_k, regularized=False):
    main, startup = m.fw.Program(), m.fw.Program()
    main.random_seed = startup.random_seed = 9
    with m.un.guard(), m.fw.program_guard(main, startup):
        x = m.L.data("x", shape=[4])
        y = m.L.data("y", shape=[1])
        h = m.L.fc(x, 8, act="tanh", param_attr=m.attr(name="bm_w1"))
        pred = m.L.fc(h, 1, param_attr=m.attr(name="bm_w2"))
        loss = m.L.mean(m.L.square(pred - y))
        inner = m.opt.Momentum(
            0.1, 0.9, regularization=m.reg.L2Decay(1e-4)
            if regularized else None)
        if merge_k > 1:
            m.opt.GradientMergeOptimizer(inner, k_steps=merge_k,
                                         avg=True).minimize(
                loss, grad_clip=None)
        else:
            inner.minimize(loss)
    return main, startup, loss


def _mlp_data():
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 4).astype("f")
    ys = rng.randn(16, 1).astype("f")
    merged = [{"x": xs[i:i + 4], "y": ys[i:i + 4]} for i in range(0, 16, 4)]
    full = [{"x": xs[i:i + 8], "y": ys[i:i + 8]} for i in range(0, 16, 8)]
    return merged, full


def test_merged_micro_batches_equal_one_larger_batch():
    jm, js, jloss = mlp(J, 2)
    tm, ts, tloss = mlp(T, 2)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    merged_feeds, full_feeds = _mlp_data()
    init, _outs, jstates = _reference(jm, js, merged_feeds, [jloss])
    _o, merged, syncs = _port(tm, init, merged_feeds, [tloss])
    fm, _fs, floss = mlp(T, 1)
    _o, full, _s = _port(fm, {n: init[n] for n in _persistables(fm)},
                         full_feeds, [floss])
    for n in ("bm_w1", "bm_w2"):
        np.testing.assert_allclose(merged[-1][n], full[-1][n],
                                   rtol=MERGE_RTOL, atol=MERGE_ATOL)
        np.testing.assert_allclose(merged[-1][n], jstates[-1][n],
                                   rtol=MERGE_RTOL, atol=MERGE_ATOL)
    # between boundaries nothing moves; after one the buffers are zero
    for step in (0, 2):
        before = init if step == 0 else merged[step - 1]
        for n in ("bm_w1", "bm_w2"):
            assert np.array_equal(merged[step][n], before[n])
    bufs = [n for n in init if ".merged_grad" in n]
    assert len(bufs) == 4
    for step in (1, 3):
        for n in bufs:
            assert not merged[step][n].any(), (step, n)
        assert not np.array_equal(merged[step]["bm_w1"],
                                  merged[step - 1]["bm_w1"])
    counter, = [n for n in init if n.startswith("gradient_merge_step")]
    assert [int(s[counter][0]) for s in merged] == [1, 2, 3, 4]
    assert syncs == [1, 1, 1, 1]


def test_l2_decay_momentum_trains_as_the_reference():
    """The review repro of the reference: the decay ops land inside the
    boundary branch with their inputs; 4 steps from the reference's
    state give its losses."""
    jm, js, jloss = mlp(J, 2, regularized=True)
    tm, _ts, tloss = mlp(T, 2, regularized=True)
    assert tm.to_dict() == jm.to_dict()
    branch = tm.block(1)
    assert {"scale", "sum", "momentum"} <= {op.type for op in branch.ops}
    assert not any(op.type == "momentum" for op in tm.global_block().ops)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(8, 4).astype("f"),
              "y": rng.randn(8, 1).astype("f")} for _ in range(4)]
    init, jouts, jstates = _reference(jm, js, feeds, [jloss])
    touts, tstates, _syncs = _port(tm, init, feeds, [tloss])
    np.testing.assert_allclose([float(o[0].ravel()[0]) for o in touts],
                               [float(o[0].ravel()[0]) for o in jouts],
                               atol=LOSS_ATOL, rtol=0)
    _state_close(tstates[-1], jstates[-1], "after 4 steps")


def test_program_shape_and_fusion():
    tm, _ts, _loss = mlp(T, 2)
    g, branch = tm.global_block(), tm.block(1)
    cond_ops = [op for op in g.ops if op.type == "conditional_block"]
    assert len(cond_ops) == 2 and cond_ops[0].attr("sub_block") == 1
    assert not tm.block(2).ops        # the default branch
    velocities = [n for n, v in g.vars.items() if "_velocity_" in n]
    assert len(velocities) == 4 and all(g.vars[n].persistable
                                        for n in velocities)
    assert not any("_velocity_" in n for n in branch.vars)
    assert any(n.startswith("learning_rate") for n in g.vars)
    written = {n for op in branch.ops for n in op.output_arg_names
               if g.has_var(n) and g.vars[n].persistable}
    assert written <= set(cond_ops[0].output("Out"))
    assert {"bm_w1", "bm_w2"} | set(velocities) <= written
    from paddle_tpu_torch import ir as tir

    tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
    assert sum(op.type == "momentum" for op in branch.ops) == 4
    assert not any(op.type.startswith("fused_") for b in tm.blocks
                   for op in b.ops)


def test_k_steps_one_is_the_inner_optimizer():
    plain, _s, _l = mlp(T, 1)
    main, startup = tfw.Program(), tfw.Program()
    main.random_seed = startup.random_seed = 9
    with tun.guard(), tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[4])
        y = tlayers.data("y", shape=[1])
        h = tlayers.fc(x, 8, act="tanh", param_attr=tpa.ParamAttr("bm_w1"))
        pred = tlayers.fc(h, 1, param_attr=tpa.ParamAttr("bm_w2"))
        loss = tlayers.mean(tlayers.square(pred - y))
        topt.GradientMergeOptimizer(topt.Momentum(0.1, 0.9),
                                    k_steps=1).minimize(loss)
    assert main.to_dict() == plain.to_dict()
    with pytest.raises(ValueError):
        topt.GradientMergeOptimizer(topt.SGD(0.1), k_steps=0)


# -- BERT_TINY under gradient merge with Adam -------------------------------------


def bert_merge(m):
    main, startup = m.fw.Program(), m.fw.Program()
    startup.random_seed = 5
    cfg = m.bert.BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                            ffn=128, max_pos=64, dropout=0.0)
    with m.un.guard(), m.fw.program_guard(main, startup):
        L = m.L
        inputs, seq_out = m.bert.bert_encoder(cfg, BERT_SEQ, False)
        mask_pos = L.data("mask_pos", shape=[1], dtype="int64")
        mask_label = L.data("mask_label", shape=[1], dtype="int64")
        picked = L.gather(L.reshape(seq_out, [-1, cfg.hidden]), mask_pos)
        trans = L.layer_norm(L.fc(picked, cfg.hidden, act="gelu"),
                             begin_norm_axis=1)
        logits = L.fc(trans, cfg.vocab_size)
        loss = L.mean(L.softmax_with_cross_entropy(logits, mask_label))
        m.opt.GradientMergeOptimizer(m.opt.Adam(1e-3), k_steps=2).minimize(
            loss)
    return main, startup, loss


def _bert_feeds(n):
    rng = np.random.RandomState(0)
    n_mask = int(BERT_BATCH * BERT_SEQ * 0.15)
    return [{"src_ids": rng.randint(0, 1024, (BERT_BATCH, BERT_SEQ, 1))
             .astype(np.int64),
             "pos_ids": np.tile(np.arange(BERT_SEQ).reshape(1, BERT_SEQ, 1),
                                (BERT_BATCH, 1, 1)).astype(np.int64),
             "sent_ids": rng.randint(0, 2, (BERT_BATCH, BERT_SEQ, 1))
             .astype(np.int64),
             "input_mask": np.ones((BERT_BATCH, BERT_SEQ, 1), np.float32),
             "mask_pos": rng.randint(0, BERT_BATCH * BERT_SEQ, n_mask)
             .astype(np.int64),
             "mask_label": rng.randint(0, 1024, (n_mask, 1)).astype(np.int64)}
            for _ in range(n)]


def test_bert_tiny_under_gradient_merge_trains_as_the_reference():
    jm, js, jloss = bert_merge(J)
    tm, ts, tloss = bert_merge(T)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    n_params = len(tm.global_block().all_parameters())
    assert sum(op.type == "adam" for op in tm.block(1).ops) == n_params
    feeds = _bert_feeds(4)
    init, jouts, jstates = _reference(jm, js, feeds, [jloss])
    touts, tstates, syncs = _port(tm, init, feeds, [tloss])
    np.testing.assert_allclose([float(o[0].ravel()[0]) for o in touts],
                               [float(o[0].ravel()[0]) for o in jouts],
                               atol=BERT_LOSS_ATOL, rtol=0)
    params = [p.name for p in tm.global_block().all_parameters()]
    moments = [n for n in init if "_moment1_" in n or "_moment2_" in n]
    bufs = [n for n in init if ".merged_grad" in n]
    assert len(moments) == 2 * n_params and len(bufs) == n_params
    top = max(float(np.abs(jstates[0][n]).max()) for n in bufs)
    noise = {n.split(".merged_grad")[0] for n in bufs
             if float(np.abs(jstates[0][n]).max()) < NOISE * top}
    assert len(noise) == 2 and all(n.endswith(".b_0") for n in noise), noise
    for step in (1, 3):
        _state_close(tstates[step], jstates[step], "window %d" % step, noise)
        assert all(not tstates[step][n].any() for n in bufs)
    for step in (0, 2):
        before = init if step == 0 else tstates[step - 1]
        assert all(np.array_equal(tstates[step][n], before[n])
                   for n in params + moments)
        _state_close({n: tstates[step][n] for n in bufs},
                     {n: jstates[step][n] for n in bufs}, "merge %d" % step,
                     noise)
    assert syncs == [1, 1, 1, 1]
    assert not any(op.type == "fused_adam" for op in tm.global_block().ops)


def test_branch_temporaries_die_inside_the_branch():
    """The branch has its own plan: the averaged gradients and the zeroing
    scales it makes are released inside it, at their last read, never
    kept for the rest of the step; what it writes outside is kept."""
    tm, ts, tloss = mlp(T, 2)
    exe = Executor(tfw.CPUPlace())
    sc = Scope()
    exe.run(ts, scope=sc)
    merged_feeds, _full = _mlp_data()
    for f in merged_feeds[:2]:
        exe.run(tm, feed=f, fetch_list=[tloss], scope=sc)
    plan, = [p for p in exe._cache.values() if p.sub_plans]
    sub = plan.sub_plans[1]
    made = {n for op in tm.block(1).ops if op.type == "scale"
            for n in op.output("Out")}
    released = {n for names in sub.release for n in names}
    assert len(made) == 8 and made <= released
    outer = set(tm.global_block().ops[[op.type for op in
                                       tm.global_block().ops].index(
                                           "conditional_block")]
                .output("Out"))
    assert outer and not outer & released
