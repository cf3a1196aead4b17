"""The recurrent layers of the PyTorch port held against the JAX package on
the CPU: ``layers/rnn.py``, the small layers it needs, contrib's
``basic_gru`` / ``basic_lstm``.

* Programs: each layer (``split``, ``squeeze``, ``stack``, ``reverse``,
  ``sequence_mask``, ``gather_tree``, ``topk``, ``log``, ``gru_unit``,
  ``lstm_unit``, ``dynamic_gru``, ``dynamic_lstm``, ``dynamic_lstmp``,
  ``lstm``, ``rnn`` over ``GRUCell`` / ``LSTMCell``, ``dynamic_decode``
  with ``BeamSearchDecoder``, ``basic_gru``, ``basic_lstm``) builds main
  and startup programs whose ``to_dict()`` equals the reference's, and
  from the reference's initial weights gives its fetches to ``ATOL``.
* The reference's own cases re-posed (``tests/test_extended_ops.py``'s
  stacked lstm / lstmp, cell classes, final states, the beam decoder's
  greedy and finished-beam checks; ``tests/test_contrib_surface.py``'s
  basic_gru / basic_lstm goldens, masks, training and dropout paths):
  the same programs train with the reference's losses to ``LOSS_RTOL``,
  and the analytic checks hold.
* Dropout: ``basic_gru``'s downgrade_in_infer and ``basic_lstm``'s
  upscale_in_train under one patched mask (``torch_rnn_common``): losses,
  outputs and the SGD-updated weights of three steps, and the inference
  clone (GRU scaled by 1 - p, LSTM the identity).
* The reference's departures from Fluid, each pinned against it.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from torch_rnn_common import J, T, build, patch_masks, run_j, run_t

ATOL = 2e-5
LOSS_RTOL = 1e-5


def _check(make, n_feeds=1, seed=None):
    """Build ``make`` in both packages (dicts equal) and run both from the
    reference's weights -> (port fetches, reference fetches)."""
    jm, js, feeds, jf = build(J, make, seed)
    tm, ts, _f, tf = build(T, make, seed)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    want, init = run_j(jm, js, feeds[:n_feeds], jf)
    got = run_t(tm, init, feeds[:n_feeds], tf)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for k, (g, w) in enumerate(zip(gs, ws)):
            assert g.shape == w.shape, (k, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                           err_msg="fetch %d" % k)
            else:
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64))
    return got, want


def _x(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


# -- programs -----------------------------------------------------------------


def small_layers(m):
    L = m.L
    x = L.data("x", shape=[1, 6, 4])
    lens = L.data("lens", shape=[], dtype="int64")
    a, b, c = L.split(x, 3, dim=2)
    s1, s2 = L.split(x, [1, 3], dim=-1)
    sq = L.squeeze(a, [1])
    st = L.stack([sq, L.squeeze(b, [1])], axis=1)
    rv = L.reverse(x, axis=[2, 3])
    rv1 = L.reverse(sq, 0)
    mk = L.sequence_mask(lens, maxlen=5, dtype="float32")
    vals, idx = L.topk(L.log(L.scale(x, bias=1.0)), 2)
    ids = L.data("ids", shape=[3, 2, 2], dtype="int64",
                 append_batch_size=False)
    par = L.data("par", shape=[3, 2, 2], dtype="int64",
                 append_batch_size=False)
    tree = L.gather_tree(ids, par)
    rng = np.random.RandomState(0)
    return [{"x": _x(3, 1, 6, 4), "lens": np.array([0, 2, 7], "int64"),
             "ids": rng.randint(0, 9, (3, 2, 2)).astype("int64"),
             "par": rng.randint(0, 2, (3, 2, 2)).astype("int64")}], \
        [a, b, c, s1, s2, sq, st, rv, rv1, mk, vals, idx, tree]


def units(m):
    L = m.L
    x3 = L.data("x3", shape=[24])
    h = L.data("h", shape=[8])
    c = L.data("c", shape=[8])
    x = L.data("x", shape=[5])
    gh, _gh2, gc = L.gru_unit(x3, h, 24)
    lh, lc = L.lstm_unit(x, h, c, forget_bias=0.5)
    return [{"x3": _x(3, 24), "h": _x(3, 8, seed=1) - 0.5,
             "c": _x(3, 8, seed=2), "x": _x(3, 5, seed=3)}], \
        [gh, gc, lh, lc]


def dynamic(m):
    L = m.L
    x = L.data("x", shape=[5, 6])
    g = L.dynamic_gru(L.fc(x, 24, num_flatten_dims=2), 8)
    h, c = L.dynamic_lstm(L.fc(x, 32, num_flatten_dims=2), 32,
                          return_cell=True)
    p, pc = L.dynamic_lstmp(L.fc(x, 32, num_flatten_dims=2), 32,
                            proj_size=5, is_reverse=True)
    return [{"x": _x(3, 5, 6)}], [g, h, c, p, pc]


def stacked(m):
    L = m.L
    x = L.data("x", shape=[6, 8])
    out, lh, lc = L.lstm(x, None, None, 6, hidden_size=10, num_layers=2,
                         is_bidirec=True)
    out1, lh1, lc1 = L.lstm(x, None, None, 6, hidden_size=4, num_layers=3,
                            name="uni")
    return [{"x": _x(2, 6, 8)}], [out, lh, lc, out1, lh1, lc1]


def cells(m):
    L = m.L
    x = L.data("x", shape=[5, 6])
    gout, glast = L.rnn(L.GRUCell(8), x)
    lout, (h, c) = L.rnn(L.LSTMCell(8, forget_bias=0.5), x,
                         is_reverse=True)
    xt = L.transpose(x, [1, 0, 2])
    tout, tlast = L.rnn(L.GRUCell(4, name="tm"), xt, time_major=True,
                        is_reverse=True)
    return [{"x": _x(3, 5, 6)}], [gout, glast, lout, h, c, tout, tlast]


def _beam_decoder(m, k, start, end, bias_vals, steps=4, h=8):
    L = m.L
    v = len(bias_vals)
    init_h = L.data("h0", shape=[h])
    cell = L.GRUCell(h)

    def embed(ids):
        return L.embedding(ids, (v, h),
                           param_attr=m.ParamAttr(name="bsd_emb"))

    def out_fn(hh):
        z = L.fc(hh, v, param_attr=m.ParamAttr(
            initializer=m.init.Constant(0.0), name="bsd_zero_w"),
            bias_attr=False)
        return L.elementwise_add(z, L.assign(bias_vals.reshape(1, v)))

    bsd = L.BeamSearchDecoder(cell, start_token=start, end_token=end,
                              beam_size=k, embedding_fn=embed,
                              output_fn=out_fn)
    outs, st = L.dynamic_decode(bsd, inits=init_h, max_step_num=steps)
    return bsd.finalize(outs), st[-2]


def beam_greedy(m):
    bias = np.array([0.1, 0.4, 0.2, 3.0, 0.3, 0.25], "f")  # argmax 3
    s1, _ = _beam_decoder(m, 1, 1, 0, bias)
    s3, sc3 = _beam_decoder(m, 3, 1, 0, bias)
    return [{"h0": np.random.RandomState(0).randn(2, 8).astype("f")}], \
        [s1, s3, sc3]


def beam_finished(m):
    bias = np.array([0.1, 5.0, 0.2, 0.3, 0.15], "f")  # argmax = end
    s, sc = _beam_decoder(m, 2, 2, 1, bias, h=4)
    return [{"h0": np.zeros((1, 4), "f")}], [s, sc]


def beam_learned(m):
    """A decoder whose logits depend on the state: an LSTMCell."""
    L = m.L
    h, v, k = 8, 11, 3
    init_h = L.data("h0", shape=[h])
    init_c = L.data("c0", shape=[h])
    cell = L.LSTMCell(h)
    bsd = L.BeamSearchDecoder(
        cell, start_token=0, end_token=1, beam_size=k,
        embedding_fn=lambda ids: L.embedding(ids, (v, h)),
        output_fn=lambda o: L.fc(o, v))
    outs, st = L.dynamic_decode(bsd, inits=[init_h, init_c],
                                max_step_num=5)
    rng = np.random.RandomState(1)
    return [{"h0": rng.randn(2, h).astype("f"),
             "c0": rng.randn(2, h).astype("f")}], \
        [bsd.finalize(outs), st[-2], st[0]]


def basic_gru_prog(bidirectional, num_layers, batch_first=True,
                   with_len=False, with_init=False):
    def make(m):
        L = m.L
        t_, i, h = 5, 4, 6
        d = 2 if bidirectional else 1
        shape = [t_, i] if batch_first else [t_, 3, i]
        x = L.data("x", shape=shape, append_batch_size=batch_first)
        feed = {"x": _x(3, t_, i) if batch_first else _x(t_, 3, i)}
        lens = h0 = None
        if with_len:
            lens = L.data("lens", shape=[], dtype="int64")
            feed["lens"] = np.array([5, 3, 1], "int64")
        if with_init:
            h0 = L.data("h0", shape=[num_layers * d, 3, h],
                        append_batch_size=False)
            feed["h0"] = _x(num_layers * d, 3, h, seed=4) - 0.5
        out, last = m.C.layers.basic_gru(
            x, h0, h, num_layers=num_layers, sequence_length=lens,
            bidirectional=bidirectional, batch_first=batch_first,
            param_attr=m.ParamAttr(name="g_w") if with_init else None)
        return [feed], [out, last]

    return make


def basic_lstm_prog(bidirectional, num_layers, with_len=False,
                    with_init=False):
    def make(m):
        L = m.L
        t_, i, h = 4, 3, 5
        d = 2 if bidirectional else 1
        x = L.data("x", shape=[t_, i])
        feed = {"x": _x(2, t_, i)}
        lens = h0 = c0 = None
        if with_len:
            lens = L.data("lens", shape=[], dtype="int64")
            feed["lens"] = np.array([2, 4], "int64")
        if with_init:
            h0 = L.data("h0", shape=[num_layers * d, 2, h],
                        append_batch_size=False)
            c0 = L.data("c0", shape=[num_layers * d, 2, h],
                        append_batch_size=False)
            feed["h0"] = _x(num_layers * d, 2, h, seed=5) - 0.5
            feed["c0"] = _x(num_layers * d, 2, h, seed=6)
        out, lh, lc = m.C.layers.basic_lstm(
            x, h0, c0, h, num_layers=num_layers, sequence_length=lens,
            bidirectional=bidirectional, forget_bias=1.0,
            gate_activation="sigmoid" if with_init else None,
            bias_attr=m.ParamAttr(name="l_b") if with_init else None)
        return [feed], [out, lh, lc]

    return make


PROGRAMS = {
    "small_layers": small_layers, "units": units, "dynamic": dynamic,
    "stacked": stacked, "beam_learned": beam_learned,
    "basic_gru_uni_1": basic_gru_prog(False, 1),
    "basic_gru_uni_2": basic_gru_prog(False, 2),
    "basic_gru_bi_2": basic_gru_prog(True, 2),
    "basic_gru_mask_init_tm": basic_gru_prog(True, 1, batch_first=False,
                                             with_len=True, with_init=True),
    "basic_lstm_uni_2": basic_lstm_prog(False, 2),
    "basic_lstm_bi_2": basic_lstm_prog(True, 2),
    "basic_lstm_mask_init": basic_lstm_prog(True, 1, with_len=True,
                                            with_init=True),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_and_fetches_match_reference(name):
    _check(PROGRAMS[name])


# the programs below are held to the reference by _check too, beside the
# reference's own checks of their fetches


def test_beam_decoder_analytic_checks():
    """The reference's analytic checks on the port's fetches: constant
    logits decode their argmax (greedy and beam agree) at Tmax times its
    log-prob; a beam that emits end_token keeps its score and end_token."""
    (got,), _ = _check(beam_greedy)
    s1, s3, sc3 = got
    assert s1.shape == (4, 2, 1) and s3.shape == (4, 2, 3)
    np.testing.assert_array_equal(s1[:, :, 0], np.full((4, 2), 3))
    np.testing.assert_array_equal(s3[:, :, 0], np.full((4, 2), 3))
    bias = np.array([0.1, 0.4, 0.2, 3.0, 0.3, 0.25], "f")
    expect = 4 * (bias[3] - np.log(np.exp(bias).sum()))
    np.testing.assert_allclose(sc3.reshape(2, 3)[:, 0], expect, rtol=1e-4)
    (got,), _ = _check(beam_finished)
    s, sc = got
    bias = np.array([0.1, 5.0, 0.2, 0.3, 0.15], "f")
    logp = bias - np.log(np.exp(bias).sum())
    assert s[0, 0, 0] == 1 and (s[1:, 0, 0] == 1).all()
    np.testing.assert_allclose(sc.reshape(1, 2)[0, 0], logp[1], rtol=1e-4)


def test_final_states_structure():
    """rnn's final states: [B, H] each, h the last output step, c != h."""
    (got,), _ = _check(cells)
    gout, glast, lout, h, c, tout, tlast = got
    assert h.shape == c.shape == (3, 8)
    np.testing.assert_allclose(glast, gout[:, -1], rtol=1e-6)
    np.testing.assert_allclose(h, lout[:, 0], rtol=1e-6)    # reversed
    np.testing.assert_allclose(tlast, tout[0], rtol=1e-6)   # time-major
    assert not np.allclose(c, h)


def test_basic_gru_mask_freezes_states():
    """Past a row's length its hidden state stays where it was, so the
    last hidden equals the output at the row's last real step."""
    (got,), _ = _check(basic_gru_prog(False, 1, with_len=True))
    out, last = got
    for b, n in enumerate([5, 3, 1]):
        np.testing.assert_allclose(last[0, b], out[b, n - 1], rtol=1e-6)


# -- training -----------------------------------------------------------------


def _train(make_net, opt, steps, seed=None, mask_layers=None,
           monkeypatch=None):
    """Losses (and the other fetches) of ``steps`` steps in each package
    from the reference's initial weights."""
    def make(m):
        feeds, fetch = make_net(m)
        opt(m).minimize(fetch[0])
        return feeds * steps, fetch

    if mask_layers is not None:
        patch_masks(monkeypatch, mask_layers)
    jm, js, feeds, jf = build(J, make, seed)
    tm, ts, _f, tf = build(T, make, seed)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    want, init = run_j(jm, js, feeds, jf)
    got = run_t(tm, init, feeds, tf)
    return got, want


def _loss(f):
    return [float(np.asarray(s[0]).ravel()[0]) for s in f]


def stacked_net(m):
    L = m.L
    x = L.data("x", shape=[6, 8])
    out, _lh, _lc = L.lstm(x, None, None, 6, hidden_size=10, num_layers=2,
                           is_bidirec=True)
    proj, _cells = L.dynamic_lstmp(L.fc(x, 32, num_flatten_dims=2), 32,
                                   proj_size=5)
    loss = L.reduce_mean(out) + L.reduce_mean(proj)
    return [{"x": _x(2, 6, 8)}], [loss]


def cells_net(m):
    L = m.L
    x = L.data("x", shape=[5, 6])
    gout, _ = L.rnn(L.GRUCell(8), x)
    lout, _ = L.rnn(L.LSTMCell(8), x)
    loss = L.reduce_mean(gout) + L.reduce_mean(lout)
    return [{"x": _x(3, 5, 6)}], [loss]


def gru_regression_net(m):
    L = m.L
    t_, b, i, h = 4, 8, 3, 6
    rng = np.random.RandomState(3)
    w = rng.randn(t_ * i, 1).astype("float32")
    x = rng.randn(b, t_, i).astype("float32")
    xin = L.data("x", shape=[t_, i])
    y = L.data("y", shape=[1])
    _out, last = m.C.layers.basic_gru(xin, None, h, num_layers=1)
    pred = L.fc(L.reshape(last, [-1, h]), 1)
    loss = L.mean(L.square(L.elementwise_sub(pred, y)))
    return [{"x": x, "y": (x.reshape(b, -1) @ w).astype("float32")}], [loss]


@pytest.mark.parametrize("net,opt,steps", [
    (stacked_net, lambda m: m.opt.SGD(0.05), 6),
    (cells_net, lambda m: m.opt.SGD(0.05), 6),
    (gru_regression_net, lambda m: m.opt.Adam(learning_rate=0.05), 15),
], ids=["stacked_lstm_lstmp", "cell_classes", "basic_gru_regression"])
def test_trains_as_the_reference(net, opt, steps):
    got, want = _train(net, opt, steps)
    np.testing.assert_allclose(_loss(got), _loss(want), rtol=LOSS_RTOL)
    assert _loss(got)[-1] < _loss(got)[0]


def dropout_net(api, p, test_clone=False):
    def make(m):
        L = m.L
        t_, i, h = 4, 4, 6
        xin = L.data("x", shape=[t_, i])
        if api == "gru":
            out, last = m.C.layers.basic_gru(xin, None, h, num_layers=2,
                                             dropout_prob=p)
            states = [last]
        else:
            out, last, cell = m.C.layers.basic_lstm(
                xin, None, None, h, num_layers=2, dropout_prob=p)
            states = [last, cell]
        loss = L.mean(L.square(out))
        return [{"x": np.random.RandomState(8).randn(3, t_, i)
                 .astype("float32")}], [loss, out] + states

    return make


@pytest.mark.parametrize("api", ["gru", "lstm"])
def test_basic_rnn_dropout_semantics_under_one_mask(monkeypatch, api):
    """Training under one mask: the reference's losses, outputs, final
    states (never dropped) and, through three SGD steps, its gradients;
    the masks of the port's run are its one draw a call."""
    got, want = _train(dropout_net(api, 0.4), lambda m: m.opt.SGD(0.5), 3,
                       mask_layers=2, monkeypatch=monkeypatch)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # the output is dropped (zeros), the last states are not
    out, states = got[0][1], got[0][2:]
    assert (out == 0).mean() > 0.2
    assert all((s != 0).all() for s in states)


@pytest.mark.parametrize("api", ["gru", "lstm"])
def test_basic_rnn_draws_fresh_masks_each_step(api):
    """The port's own draws (no patch): each training step keys the op's
    masks by its seed, so two steps on one feed differ, and the inference
    clone draws none."""
    main, startup = T.fw.Program(), T.fw.Program()
    with T.un.guard(), T.fw.program_guard(main, startup):
        feeds, fetch = dropout_net(api, 0.4)(T)
        test_prog = main.clone(for_test=True)
    init = run_j(*build(J, dropout_net(api, 0.4))[:2], [], [])[1]
    a, b = run_t(main, init, feeds * 2, fetch[:2])
    c, d = run_t(test_prog, init, feeds * 2, fetch[:2])
    assert np.isfinite(a[0]).all() and not np.array_equal(a[1], b[1])
    np.testing.assert_array_equal(c[1], d[1])


@pytest.mark.parametrize("api", ["gru", "lstm"])
def test_basic_rnn_grad_draws_the_forward_masks(monkeypatch, api):
    """The port's own Philox draws (no patched mask): the grad op draws
    the forward's masks again from the forward op's seed, so a training
    step's parameter gradients are the vjp of the plain recurrence under
    the masks the forward applied (the zeros of its Out)."""
    import torch
    from paddle_tpu_torch.backward import append_backward
    from paddle_tpu_torch.core import Executor, Scope
    from paddle_tpu_torch.ops import rnn as trnn

    draws, real = [], trnn.rnn_keep_masks

    def spy(words, shape, dropout_prob, device):
        draws.append(real(words, shape, dropout_prob, device))
        return draws[-1]

    monkeypatch.setattr(trnn, "rnn_keep_masks", spy)
    main, startup = T.fw.Program(), T.fw.Program()
    with T.un.guard(), T.fw.program_guard(main, startup):
        feeds, fetch = dropout_net(api, 0.4)(T)
        append_backward(fetch[0])
    op = next(o for o in main.global_block().ops
              if o.type == "basic_%s_rnn" % api)
    slots = (("GateWeight", "CandWeight", "GateBias", "CandBias")
             if api == "gru" else ("Weight", "Bias"))
    weights = [op.input(s) for s in slots]
    names = [n for ws in weights for n in ws]
    exe, scope = Executor(T.fw.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    x, out, *grads = exe.run(
        main, feed=feeds[0], scope=scope,
        fetch_list=[op.input("Input")[0], op.output("Out")[0]]
        + [n + "@GRAD" for n in names])
    assert len(draws) == 2     # the forward's draw, the grad op's again
    keep = draws[0]
    assert torch.equal(draws[1], keep)
    assert (~keep).any() and keep.any()
    np.testing.assert_array_equal(keep[:, -1].numpy(), out != 0)
    vals = [[torch.from_numpy(scope.find_var(n).get_tensor().numpy())
             for n in ws] for ws in weights]
    if api == "gru":
        def fwd(*ws):
            return trnn.gru_recurrence(torch.from_numpy(x), None, None,
                                       *ws, keep, **op.attrs)
    else:
        def fwd(*ws):
            return trnn.lstm_recurrence(torch.from_numpy(x), None, None,
                                        None, *ws, keep, **op.attrs)
    outs, vjp_fn = torch.func.vjp(fwd, *vals)
    out_t = torch.from_numpy(out)
    cots = (2.0 * out_t / out_t.numel(),) + tuple(
        torch.zeros_like(o) for o in outs[1:])    # mean(square(out))
    want = [g for gs in vjp_fn(cots) for g in gs]
    np.testing.assert_allclose(outs[0].numpy(), out, atol=ATOL, rtol=0)
    for n, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("api", ["gru", "lstm"])
def test_basic_rnn_inference_scaling(api):
    """The inference clone: basic_gru (downgrade_in_infer) scales each
    layer's output by 1 - p, basic_lstm (upscale_in_train) passes it."""
    def make(m):
        feeds, fetch = dropout_net(api, 0.4)(m)
        prog = m.fw.default_main_program().clone(for_test=True)
        return feeds, (fetch, prog)

    res = {}
    for name, m in (("j", J), ("t", T)):
        main, startup = m.fw.Program(), m.fw.Program()
        with m.un.guard(), m.fw.program_guard(main, startup):
            feeds, (fetch, test_prog) = make(m)
        res[name] = (main, startup, test_prog, feeds, fetch)
    jm, js, jtest, feeds, jf = res["j"]
    tm, _ts, ttest, _f, tf = res["t"]
    assert ttest.to_dict() == jtest.to_dict()
    assert all(op.attr("is_test") for op in ttest.global_block().ops
               if op.type.startswith("basic_"))
    (want,), init = run_j(jtest, js, feeds, jf)
    (got,) = run_t(ttest, init, feeds, tf)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # against the same net at p = 0 from the same weights
    m0 = {}
    for name, m in (("j", J), ("t", T)):
        main, startup = m.fw.Program(), m.fw.Program()
        with m.un.guard(), m.fw.program_guard(main, startup):
            m0[name] = dropout_net(api, 0.0)(m)[1]
        m0[name] = (main, m0[name])
    (base,) = run_t(m0["t"][0], init, feeds, m0["t"][1])
    if api == "lstm":
        np.testing.assert_allclose(got[1], base[1], atol=ATOL)
    else:
        assert not np.allclose(got[1], base[1], atol=1e-3)


# -- the reference's departures from Fluid ------------------------------------


def _raises_in_both(make, exc, match):
    for m in (J, T):
        main, startup = m.fw.Program(), m.fw.Program()
        with pytest.raises(exc, match=match):
            with m.un.guard(), m.fw.program_guard(main, startup):
                make(m)


def test_rnn_sequence_length_raises():
    def make(m):
        x = m.L.data("x", shape=[4, 3])
        lens = m.L.data("lens", shape=[], dtype="int64")
        m.L.rnn(m.L.GRUCell(4), x, sequence_length=lens)

    _raises_in_both(make, NotImplementedError, "sequence_length")


def test_dynamic_decode_needs_max_step_num():
    def make(m):
        h0 = m.L.data("h0", shape=[4])
        bsd = m.L.BeamSearchDecoder(m.L.GRUCell(4), 0, 1, 2,
                                    embedding_fn=lambda i: m.L.embedding(
                                        i, (5, 4)))
        m.L.dynamic_decode(bsd, inits=h0)

    _raises_in_both(make, ValueError, "max_step_num")


@pytest.mark.parametrize("kw", [{"gate_activation": "relu"},
                                {"activation": "sigmoid"}])
def test_lstm_cell_takes_sigmoid_and_tanh_only(kw):
    _raises_in_both(lambda m: m.L.LSTMCell(4, **kw), NotImplementedError,
                    "sigmoid")


def test_gru_unit_named_attr_raises_as_the_reference():
    """One named param_attr over the gates' [D, 2D] and the candidate's
    [D, D] fc: the layer helper's shared-parameter check raises."""
    def make(m):
        x3 = m.L.data("x3", shape=[12])
        h = m.L.data("h", shape=[4])
        m.L.gru_unit(x3, h, 12, param_attr=m.ParamAttr(name="shared"))

    _raises_in_both(make, ValueError, "shared parameter 'shared'")


def test_dynamic_rnns_ignore_seq_len_and_reverse():
    """dynamic_gru / dynamic_lstm take seq_len and reverse and read
    neither: the programs equal the ones built without them, in both
    packages."""
    def net(m, **kw):
        x = m.L.data("x", shape=[5, 6])
        lens = m.L.data("lens", shape=[], dtype="int64")
        extra = {"seq_len": lens} if kw else {}
        m.L.dynamic_gru(m.L.fc(x, 12, num_flatten_dims=2), 4,
                        reverse=bool(kw), **extra)
        m.L.dynamic_lstm(m.L.fc(x, 16, num_flatten_dims=2), 16,
                         reverse=bool(kw), **extra)
        return [], []

    for m in (J, T):
        plain = build(m, lambda mm: net(mm))[0].to_dict()
        given = build(m, lambda mm: net(mm, ignored=True))[0].to_dict()
        assert plain == given


def test_lstm_reads_no_init_states():
    """layers.lstm runs from zero states whatever init_h / init_c hold
    (and its final states are the last layer's, [B, 1, H])."""
    def make(m):
        x = m.L.data("x", shape=[4, 3])
        h0 = m.L.data("h0", shape=[1, 2, 5], append_batch_size=False)
        out, lh, lc = m.L.lstm(x, h0, h0, 4, hidden_size=5, num_layers=1)
        x_v = _x(2, 4, 3)
        return [{"x": x_v, "h0": np.zeros((1, 2, 5), "f")},
                {"x": x_v, "h0": _x(1, 2, 5) + 1.0}], [out, lh, lc]

    got, _ = _check(make, n_feeds=2)
    assert got[0][1].shape == (2, 1, 5)
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)


def test_basic_units_wait_for_dygraph():
    from paddle_tpu_torch.contrib.layers import BasicGRUUnit, BasicLSTMUnit

    for cls in (BasicGRUUnit, BasicLSTMUnit):
        with pytest.raises(NotImplementedError, match="dygraph"):
            cls("unit", 4)
    assert set(T.C.layers.__all__) == set(
        fluid.contrib.layers.rnn_impl.__all__)
