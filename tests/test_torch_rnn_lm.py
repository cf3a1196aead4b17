"""The recurrent slice as a whole on the CPU: the PTB LSTM language model
(``models/ptb_lm.py``) and contrib's decoders, the port against the JAX
package.

* PTB-LM at ``PTB_TINY`` (vocab 50, hidden 16, 2 layers, 6 steps, batch
  4) in both LSTM emissions (``basic_lstm``: one ``basic_lstm_rnn`` op;
  ``cudnn``: ``layers.lstm``'s StaticRNNs) and both GRU ones
  (``basic_gru``; ``dynamic_gru`` under ``rnn(GRUCell)``) builds the
  reference's main and startup programs (the reference's SGD under
  ``set_gradient_clip``, whose optimizers take no ``grad_clip=``) and
  trains 5 steps of SGD(1.0) under the global-norm clip from the
  reference's initial weights, every emission but ``cudnn`` (whose
  ``lstm`` reads no init states) carrying its final states into the next
  batch's init: losses, carried states and the final weights to
  ``ATOL``, at dropout 0 and at dropout 0.5 under one mask
  (``torch_rnn_common.patch_masks``).
* contrib's ``TrainingDecoder`` and ``BeamSearchDecoder`` on the
  reference's ``StateCell`` (``tests/test_contrib_tail.py``): programs
  equal, fetches equal, and the reference's checks (the teacher-forced
  recurrence in numpy, the beam invariants, the top-k pruned branch).
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib.layers import basic_gru as jbasic_gru
from paddle_tpu.contrib.layers import basic_lstm as jbasic_lstm
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.models import ptb_lm
import paddle_tpu_torch.framework as tfw
from torch_rnn_common import J, T, build, patch_masks, run_j, run_t

ATOL = 2e-5   # f32 after 5 SGD steps at lr 1.0, losses ~23


def ref_lm(cfg, rnn_model):
    """PaddleNLP's lm_model through the reference's layers, as
    ``ptb_lm.build_train`` builds it through the port's."""
    L = fluid.layers
    h, nl, ns, b = (cfg.hidden_size, cfg.num_layers, cfg.num_steps,
                    cfg.batch_size)

    def uniform():
        return fluid.initializer.UniformInitializer(low=-cfg.init_scale,
                                                    high=cfg.init_scale)

    x = L.data(name="x", shape=[b, ns, 1], dtype="int64",
               append_batch_size=False)
    y = L.data(name="y", shape=[b * ns, 1], dtype="int64",
               append_batch_size=False)
    ih = L.data(name="init_hidden", shape=[nl, b, h], dtype="float32",
                append_batch_size=False)
    ic = L.data(name="init_cell", shape=[nl, b, h], dtype="float32",
                append_batch_size=False)
    ihr = L.reshape(ih, shape=[nl, -1, h])
    icr = L.reshape(ic, shape=[nl, -1, h])
    emb = L.embedding(input=x, size=[cfg.vocab_size, h], dtype="float32",
                      is_sparse=False,
                      param_attr=fluid.ParamAttr(name="embedding_para",
                                                 initializer=uniform()))
    emb = L.reshape(emb, shape=[-1, ns, h])
    if cfg.dropout:
        emb = L.dropout(emb, dropout_prob=cfg.dropout,
                        dropout_implementation="upscale_in_train")
    if rnn_model == "cudnn":
        out, lh, lc = L.lstm(emb, ihr, icr, ns, h, nl,
                             dropout_prob=cfg.dropout,
                             default_initializer=uniform())
        if cfg.dropout:
            out = L.dropout(out, dropout_prob=cfg.dropout,
                            dropout_implementation="upscale_in_train")
    elif rnn_model == "basic_gru":
        out, lh = jbasic_gru(
            emb, ih, h, num_layers=nl, batch_first=True,
            dropout_prob=cfg.dropout,
            param_attr=fluid.ParamAttr(initializer=uniform()),
            bias_attr=fluid.ParamAttr(
                initializer=fluid.initializer.Constant(0.0)))
        lc = None
    elif rnn_model == "dynamic_gru":
        out1 = L.dynamic_gru(
            L.fc(emb, 3 * h, num_flatten_dims=2), h,
            h_0=L.reshape(L.slice(ihr, axes=[0], starts=[0], ends=[1]),
                          [-1, h]))
        last_1 = L.reshape(L.slice(out1, axes=[1], starts=[ns - 1],
                                   ends=[ns]), [1, -1, h])
        if cfg.dropout:
            out1 = L.dropout(out1, dropout_prob=cfg.dropout,
                             dropout_implementation="upscale_in_train")
        h_1 = L.reshape(L.slice(ihr, axes=[0], starts=[1], ends=[2]),
                        [-1, h])
        out, last_2 = L.rnn(L.GRUCell(h), out1, initial_states=h_1)
        if cfg.dropout:
            out = L.dropout(out, dropout_prob=cfg.dropout,
                            dropout_implementation="upscale_in_train")
        lh = L.concat([last_1, L.reshape(last_2, [1, -1, h])], axis=0)
        lc = None
    else:
        out, lh, lc = jbasic_lstm(
            emb, ih, ic, h, num_layers=nl, batch_first=True,
            dropout_prob=cfg.dropout,
            param_attr=fluid.ParamAttr(initializer=uniform()),
            bias_attr=fluid.ParamAttr(
                initializer=fluid.initializer.Constant(0.0)),
            forget_bias=0.0)
    out = L.reshape(out, shape=[-1, ns, h])
    sw = L.create_parameter([h, cfg.vocab_size], dtype="float32",
                            name="softmax_weight",
                            default_initializer=uniform())
    sb = L.create_parameter([cfg.vocab_size], dtype="float32",
                            name="softmax_bias", default_initializer=uniform())
    proj = L.reshape(L.elementwise_add(L.matmul(out, sw), sb),
                     shape=[-1, cfg.vocab_size])
    loss = L.softmax_with_cross_entropy(logits=proj, label=y,
                                        soft_label=False)
    loss = L.reduce_sum(L.reduce_mean(L.reshape(loss, shape=[-1, ns]),
                                      dim=[0]))
    fluid.clip.set_gradient_clip(
        fluid.clip.GradientClipByGlobalNorm(clip_norm=cfg.max_grad_norm))
    try:
        fluid.optimizer.SGD(learning_rate=cfg.lr).minimize(loss)
    finally:
        fluid.clip.set_gradient_clip(None)
    return loss, lh, lc


def _train(cfg, step, feeds, carry):
    """Run ``step(feed) -> (loss, last_h, last_c)`` over the batches,
    carrying the final states into the next init where ``carry``."""
    z = np.zeros((cfg.num_layers, cfg.batch_size, cfg.hidden_size), "f")
    h, c, out = z, z, []
    for f in feeds:
        loss, lh, *lc = step(dict(f, init_hidden=h, init_cell=c))
        lc = np.asarray(lc[0]) if lc else None
        out.append((float(np.asarray(loss).ravel()[0]), np.asarray(lh), lc))
        if carry:
            h, c = np.asarray(lh), (lc if lc is not None else z)
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("rnn_model", ["basic_lstm", "cudnn", "basic_gru",
                                       "dynamic_gru"])
def test_ptb_lm_trains_as_the_reference(monkeypatch, rnn_model, dropout):
    cfg = ptb_lm.PTB_TINY.replace(dropout=dropout)
    if dropout:
        patch_masks(monkeypatch, cfg.num_layers)
    jm, js = fluid.Program(), fluid.Program()
    with J.un.guard(), fluid.program_guard(jm, js):
        jf = ref_lm(cfg, rnn_model)
    tm, ts = tfw.Program(), tfw.Program()
    with T.un.guard(), tfw.program_guard(tm, ts):
        tf = ptb_lm.build_train(cfg, rnn_model)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    kinds = [op.type for op in tm.global_block().ops]
    one_op = rnn_model.startswith("basic_")
    assert (rnn_model + "_rnn" in kinds) == one_op
    assert ("recurrent" in kinds) != one_op
    assert kinds.count("dropout") == (0 if not dropout else
                                      1 if one_op else 3)
    feeds = list(ptb_lm.batches(cfg, 5, seed=1))
    carry = rnn_model != "cudnn"    # layers.lstm reads no init states
    params = [p.name for p in jm.global_block().all_parameters()]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {v.name: np.array(scope.find_var(v.name).get_tensor()
                                 .numpy())
                for v in jm.list_vars() if v.persistable and not v.is_data}
        want = _train(cfg, lambda f: exe.run(
            jm, feed=f, fetch_list=[v for v in jf if v is not None]),
            feeds, carry)
        want_w = {n: np.array(scope.find_var(n).get_tensor().numpy())
                  for n in params}
    texe, tscope = Executor(tfw.CPUPlace()), Scope()
    tscope = scope_from_numpy(tscope, init, "cpu", program=tm)
    got = _train(cfg, lambda f: texe.run(
        tm, feed=f, fetch_list=[v for v in tf if v is not None],
        scope=tscope), feeds, carry)
    for (gl, gh, gc), (wl, wh, wc) in zip(got, want):
        assert abs(gl - wl) <= ATOL * max(1.0, abs(wl))
        np.testing.assert_allclose(gh, wh, atol=ATOL, rtol=0)
        if wc is not None:
            np.testing.assert_allclose(gc, wc, atol=ATOL, rtol=0)
    for n in params:
        np.testing.assert_allclose(tscope.find_var(n).get_tensor().numpy(),
                                   want_w[n], atol=ATOL, rtol=0,
                                   err_msg=n)
    if not dropout and rnn_model in ("basic_lstm", "cudnn"):
        # Zaremba's recipe learns at lr 1.0 (at 0.5 five steps of a tiny
        # net are noise; the GRU emissions step past the minimum there)
        assert got[-1][0] < got[0][0]


# -- contrib's decoders -------------------------------------------------------


def _cell(m, d, batch):
    """The reference test's StateCell: h' = tanh(fc([h, x]))."""
    ctx = m.L.data("ctx0", shape=[batch, d], append_batch_size=False)
    cell = m.C.decoder.StateCell(inputs={"x": None},
                                 states={"h": m.C.decoder.InitState(
                                     init=ctx)},
                                 out_state="h")

    @cell.state_updater
    def updater(cell):
        cur, prev = cell.get_input("x"), cell.get_state("h")
        cell.set_state("h", m.L.fc(
            [prev, cur], d, act="tanh",
            param_attr=[m.ParamAttr(name="dec_wh"),
                        m.ParamAttr(name="dec_wx")],
            bias_attr=m.ParamAttr(name="dec_b")))

    return cell


def training_decoder(m):
    b, t_, d = 2, 4, 3
    cell = _cell(m, d, b)
    trg = m.L.data("trg", shape=[t_, b, d], append_batch_size=False)
    decoder = m.C.decoder.TrainingDecoder(cell)
    with decoder.block():
        cur = decoder.step_input(trg)
        decoder.state_cell.compute_state(inputs={"x": cur})
        out = decoder.state_cell.get_state("h")
        decoder.state_cell.update_states()
        decoder.output(out)
    rng = np.random.RandomState(3)
    return [{"ctx0": rng.randn(b, d).astype("f"),
             "trg": rng.randn(t_, b, d).astype("f")}], [decoder()]


def beam_decoder(topk_size, v, max_len, seed):
    def make(m):
        b, d, k = 2, 4, 2
        cell = _cell(m, d, b)
        init_ids = m.L.data("init_ids", shape=[b, k], dtype="int64",
                            append_batch_size=False)
        init_scores = m.L.data("init_scores", shape=[b, k],
                               append_batch_size=False)
        decoder = m.C.decoder.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=v, word_dim=d, topk_size=topk_size,
            max_len=max_len, beam_size=k, end_id=1)
        decoder.decode()
        ids, scores = decoder()
        rng = np.random.RandomState(seed)
        return [{"ctx0": rng.randn(b, d).astype("f"),
                 "init_ids": np.zeros((b, k), "int64"),
                 "init_scores": np.zeros((b, k), "f")}], [ids, scores]

    return make


def _both(make, seed):
    jm, js, feeds, jf = build(J, make, seed)
    tm, ts, _f, tf = build(T, make, seed)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    (want,), init = run_j(jm, js, feeds, jf)
    (got,) = run_t(tm, init, feeds, tf)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)
    return got, init, feeds[0]


def test_training_decoder_matches_reference_and_numpy():
    (got,), init, feed = _both(training_decoder, 5)
    h, want = feed["ctx0"], []
    for t in range(feed["trg"].shape[0]):
        h = np.tanh(h @ init["dec_wh"] + feed["trg"][t] @ init["dec_wx"]
                    + init["dec_b"])
        want.append(h)
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("topk_size,v,max_len,seed", [
    (7, 7, 3, 9), (3, 9, 2, 13)], ids=["greedy", "topk_prune"])
def test_beam_search_decoder_matches_reference(topk_size, v, max_len, seed):
    (ids, scores), _init, _feed = _both(
        beam_decoder(topk_size, v, max_len, seed + 1), seed)
    assert ids.size > 0 and np.all((ids >= 0) & (ids < v))
    assert np.all(np.isfinite(scores))
    if topk_size == v:
        # the -1e9 seeding of beams 1..K-1: step 0 draws K distinct tokens
        assert len(np.unique(ids)) >= 2
