"""The recurrent nets' ops in the PyTorch port held against the JAX
package's lowerings on the CPU.

* Every op the recurrent layers need (``split``, ``squeeze2``,
  ``reverse``, ``stack``, ``log``, ``sequence_mask``, ``gather_tree``)
  and every recurrence (``basic_gru_rnn``, ``basic_lstm_rnn``, ``gru``,
  ``gru_unit``, ``lstm``, ``lstmp``, ``lstm_unit``, ``cudnn_lstm``,
  ``fusion_gru``, ``fusion_lstm``), as one parametrised test over the
  cases: the forward outputs to ``ATOL``, and for the differentiable ops
  each input's gradient under one random cotangent per output, the
  reference's ``<type>_grad`` (a ``jax.vjp``) against the port's
  (the vjp replay, or ``basic_*_rnn``'s written-out grad) to
  ``GRAD_ATOL``.  Weights and inputs are independent random blocks, so a
  gate order the port took from another function shows.
* ``gather_tree`` on the reference's golden case, ``sequence_mask``'s
  static-maxlen rule, the duplicable outputs of ``split``.
* The element-index rule of ``basic_*_rnn``'s masks: one draw of the
  dropout op's byte stream over [T, L, B, H], keyed by the op's seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops.common import byte_threshold

ATOL = 2e-5        # f32 forward outputs, values of order 1
GRAD_ATOL = 1e-4   # f32 input gradients, summed over T steps

NEW_TYPES = ("split", "squeeze2", "reverse", "stack", "log",
             "sequence_mask", "gather_tree", "basic_gru_rnn",
             "basic_lstm_rnn", "gru", "gru_unit", "lstm", "lstmp",
             "lstm_unit", "cudnn_lstm", "fusion_gru", "fusion_lstm")


def _rand(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _j(a):
    if a is None:
        return None
    if isinstance(a, list):
        return [jnp.asarray(v) for v in a]
    return jnp.asarray(a)


def _t(a):
    if a is None:
        return None
    if isinstance(a, list):
        return [torch.from_numpy(np.array(v)) for v in a]
    return torch.from_numpy(np.array(a))


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _cases():
    rng = np.random.RandomState(0)
    t_, b, i, h, l_ = 6, 3, 5, 8, 2
    x_tm = _rand(rng, t_, b, i, scale=1.0)
    mask = (np.arange(t_)[:, None] < np.array([6, 4, 1])[None, :]) \
        .astype(np.float32)
    gate_w = [_rand(rng, i + h, 2 * h), _rand(rng, 2 * h, 2 * h)]
    cand_w = [_rand(rng, i + h, h), _rand(rng, 2 * h, h)]
    gate_b = [_rand(rng, 2 * h), _rand(rng, 2 * h)]
    cand_b = [_rand(rng, h), _rand(rng, h)]
    lw = [_rand(rng, i + h, 4 * h), _rand(rng, 2 * h, 4 * h)]
    lb = [_rand(rng, 4 * h), _rand(rng, 4 * h)]
    h0, c0 = _rand(rng, l_, b, h), _rand(rng, l_, b, h)
    gru_attrs = {"hidden_size": h, "num_layers": l_}
    x_bm = _rand(rng, b, t_, i, scale=1.0)
    d = 7
    ids = np.array([[[2, 2]], [[3, 4]], [[5, 6]]], "int64")
    parents = np.array([[[0, 0]], [[0, 0]], [[1, 0]]], "int64")
    fin, p = 4, 3
    blob_len = (fin * 4 * d + d * 4 * d + 8 * d) * 2 \
        + (2 * d * 4 * d + d * 4 * d + 8 * d) * 2
    return [
        ("split", [_rand(rng, 4, 6, 2), None, []],
         {"axis": 1, "num": 3}),
        ("split", [_rand(rng, 4, 6), None, []],
         {"axis": -1, "sections": [1, 3, 2]}),
        ("split", [_rand(rng, 5, 3), np.array([1], "int32"), []],
         {"axis": 0, "sections": [2, 2]}),      # AxisTensor is not read
        ("squeeze2", [_rand(rng, 1, 4, 1, 3)], {"axes": [0, 2]}),
        ("squeeze2", [_rand(rng, 1, 4, 1, 3)], {"axes": [-2, 1]}),
        ("squeeze2", [_rand(rng, 1, 4, 1, 3)], {"axes": []}),
        ("reverse", [_rand(rng, 4, 5, 3)], {"axis": [0]}),
        ("reverse", [_rand(rng, 4, 5, 3)], {"axis": [1, 2]}),
        ("stack", [[_rand(rng, 3, 4) for _ in range(3)]], {"axis": 1}),
        ("log", [np.abs(_rand(rng, 3, 4)) + 0.1], {}),
        ("sequence_mask", [np.array([3, 0, 5], "int64"), None],
         {"maxlen": 6, "out_dtype": 5}),
        ("sequence_mask", [np.array([[1, 2], [4, 0]], "int64"),
                           np.array([5], "int64")],
         {"maxlen": -1, "out_dtype": 3}),
        ("gather_tree", [ids, parents], {}),
        ("gather_tree", [rng.randint(0, 9, (5, 2, 3)).astype("int64"),
                         rng.randint(0, 3, (5, 2, 3)).astype("int64")], {}),
        ("basic_gru_rnn", [x_tm, None, None, gate_w, cand_w, gate_b,
                           cand_b], dict(gru_attrs)),
        ("basic_gru_rnn", [x_tm, h0, mask, gate_w, cand_w, gate_b, cand_b],
         dict(gru_attrs, activation="relu")),
        ("basic_gru_rnn", [x_tm, h0, None, gate_w, cand_w, gate_b, cand_b],
         dict(gru_attrs, dropout_prob=0.3, is_test=True)),
        ("basic_lstm_rnn", [x_tm, None, None, None, lw, lb],
         dict(gru_attrs, forget_bias=1.0)),
        ("basic_lstm_rnn", [x_tm, h0, c0, mask, lw, lb],
         dict(gru_attrs, forget_bias=0.0)),
        ("basic_lstm_rnn", [x_tm, h0, c0, None, lw, lb],
         dict(gru_attrs, forget_bias=0.5, dropout_prob=0.3, is_test=True)),
        ("gru", [_rand(rng, b, t_, 3 * d), _rand(rng, b, d),
                 _rand(rng, d, 3 * d), _rand(rng, 1, 3 * d)], {}),
        ("gru", [_rand(rng, b, t_, 3 * d), None, _rand(rng, d, 3 * d),
                 None], {"is_reverse": True, "origin_mode": True,
                         "activation": "relu"}),
        ("gru_unit", [_rand(rng, b, 3 * d), _rand(rng, b, d),
                      _rand(rng, d, 3 * d), _rand(rng, 1, 3 * d)], {}),
        ("gru_unit", [_rand(rng, b, 3 * d), _rand(rng, b, d),
                      _rand(rng, d, 3 * d), None],
         {"activation": 3, "gate_activation": 1, "origin_mode": True}),
        ("lstm", [_rand(rng, b, t_, 4 * d), _rand(rng, b, d),
                  _rand(rng, b, d), _rand(rng, d, 4 * d),
                  _rand(rng, 1, 7 * d)], {}),
        ("lstm", [_rand(rng, b, t_, 4 * d), None, None,
                  _rand(rng, d, 4 * d), _rand(rng, 1, 4 * d)],
         {"is_reverse": True, "use_peepholes": False,
          "candidate_activation": "relu"}),
        ("lstmp", [_rand(rng, b, t_, 4 * d), _rand(rng, b, p),
                   _rand(rng, b, d), _rand(rng, p, 4 * d),
                   _rand(rng, d, p), _rand(rng, 1, 7 * d)], {}),
        ("lstmp", [_rand(rng, b, t_, 4 * d, scale=2.0), None, None,
                   _rand(rng, p, 4 * d, scale=2.0), _rand(rng, d, p),
                   None],
         {"is_reverse": True, "cell_clip": 0.5, "proj_clip": 0.3,
          "proj_activation": "identity"}),
        ("lstm_unit", [_rand(rng, b, 4 * d), _rand(rng, b, d)],
         {"forget_bias": 0.7}),
        ("cudnn_lstm", [x_bm[..., :fin], _rand(rng, 4, b, d),
                        _rand(rng, 4, b, d), _rand(rng, blob_len)],
         {"hidden_size": d, "num_layers": 2, "is_bidirec": True,
          "max_len": t_}),
        ("cudnn_lstm", [x_bm[..., :fin], None, None,
                        _rand(rng, fin * 4 * d + d * 4 * d + 8 * d)],
         {"hidden_size": d, "num_layers": 1}),
        ("fusion_gru", [x_bm, _rand(rng, b, d), _rand(rng, i, 3 * d),
                        _rand(rng, d, 3 * d), _rand(rng, 1, 3 * d)],
         {"origin_mode": True}),
        ("fusion_gru", [x_bm, None, _rand(rng, i, 3 * d),
                        _rand(rng, d, 3 * d), None], {"is_reverse": True}),
        ("fusion_lstm", [x_bm, _rand(rng, b, d), _rand(rng, b, d),
                         _rand(rng, i, 4 * d), _rand(rng, d, 4 * d),
                         _rand(rng, 1, 7 * d)], {}),
        ("fusion_lstm", [x_bm, None, None, _rand(rng, i, 4 * d),
                         _rand(rng, d, 4 * d), None],
         {"is_reverse": True}),
    ]


_CASES = _cases()


def _float(a):
    items = a if isinstance(a, list) else [a]
    return a is not None and bool(items) and all(
        np.issubdtype(np.asarray(v).dtype, np.floating) for v in items)


def _close(got, want, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("case", range(len(_CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_CASES)])
def test_op_and_grad_match_reference(case):
    op_type, args, attrs = _CASES[case]
    jdef, tdef = jreg.get_op_def(op_type), treg.get_op_def(op_type)
    attrs = dict(tdef.default_attrs, **attrs)
    assert dict(jdef.default_attrs, **attrs) == attrs
    want = _tuple(jdef.lower(JCtx(mode="eager"), *map(_j, args), **attrs))
    got = _tuple(tdef.lower(TCtx(torch.device("cpu")), *map(_t, args),
                            **attrs))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, (op_type, k)
            continue
        if isinstance(w, list):
            assert len(g) == len(w)
            for n, (gi, wi) in enumerate(zip(g, w)):
                _close(gi.numpy(), wi, ATOL, "%s out %d.%d" % (op_type, k, n))
        else:
            _close(g.numpy(), w, ATOL, "%s out %d" % (op_type, k))
    if tdef.grad_maker != "auto" or not any(map(_float, args)):
        return
    # one cotangent per output (per piece of a duplicable one)
    rng = np.random.RandomState(case)
    cots = []
    for w in want:
        if w is None or not np.issubdtype(
                np.asarray(w[0] if isinstance(w, list) else w).dtype,
                np.floating):
            cots.append(None)
        elif isinstance(w, list):
            cots.append([_rand(rng, *np.shape(wi), scale=1.0) for wi in w])
        else:
            cots.append(_rand(rng, *np.shape(w), scale=1.0))
    jargs, targs = list(map(_j, args)), list(map(_t, args))
    for w, g, c in zip(want, got, cots):
        jargs += [w, _j(c)]
        targs += [g, _t(c)]
    jg = jreg.get_op_def(op_type + "_grad").lower(JCtx(mode="eager"),
                                                  *jargs, **attrs)
    tg = treg.get_op_def(op_type + "_grad").lower(
        TCtx(torch.device("cpu")), *targs, **attrs)
    for slot, a, gw, gt in zip(tdef.input_slots, args, jg, tg):
        if not _float(a):
            continue
        if isinstance(a, list):
            for n, (gi, wi) in enumerate(zip(gt, gw)):
                _close(gi.numpy(), wi, GRAD_ATOL,
                       "%s d%s[%d]" % (op_type, slot, n))
        else:
            _close(gt.numpy(), gw, GRAD_ATOL, "%s d%s" % (op_type, slot))


def test_every_new_op_type_is_registered():
    assert set(NEW_TYPES) <= set(treg.all_op_types())
    assert set(NEW_TYPES) <= set(jreg.all_op_types())
    for t in ("basic_gru_rnn", "basic_lstm_rnn"):
        assert treg.get_op_def(t).n_rng == jreg.get_op_def(t).n_rng == 1


def test_gather_tree_golden():
    """The reference's golden case: beam 0 at t=2 came from parent 1 at
    t=1 (id 4), which came from beam 0 at t=0 (id 2)."""
    ids = np.array([[[2, 2]], [[3, 4]], [[5, 6]]], "int64")
    parents = np.array([[[0, 0]], [[0, 0]], [[1, 0]]], "int64")
    out = treg.get_op_def("gather_tree").lower(
        TCtx(torch.device("cpu")), _t(ids), _t(parents))
    np.testing.assert_array_equal(out.numpy()[:, 0, 0], [2, 4, 5])


def test_sequence_mask_needs_a_static_maxlen():
    x = np.array([2, 3], "int64")
    with pytest.raises(ValueError, match="maxlen"):
        jreg.get_op_def("sequence_mask").lower(JCtx(mode="eager"), _j(x),
                                               None, maxlen=-1)
    with pytest.raises(ValueError, match="maxlen"):
        treg.get_op_def("sequence_mask").lower(TCtx(torch.device("cpu")),
                                               _t(x), None, maxlen=-1)


@pytest.mark.parametrize("op_type", ["basic_gru_rnn", "basic_lstm_rnn"])
def test_rnn_masks_are_one_draw_over_the_block(op_type):
    """The op's masks: byte ((t L + l) B + b) H + h of the stream keyed by
    its seed, keep iff below round((1 - p) 256); one draw a call."""
    t_, l_, b, h, i, p = 4, 2, 3, 5, 6, 0.4
    rng = np.random.RandomState(1)
    x = _t(_rand(rng, t_, b, i))
    if op_type == "basic_gru_rnn":
        ws = [[_t(_rand(rng, i + h, 2 * h)), _t(_rand(rng, 2 * h, 2 * h))],
              [_t(_rand(rng, i + h, h)), _t(_rand(rng, 2 * h, h))],
              [_t(_rand(rng, 2 * h)), _t(_rand(rng, 2 * h))],
              [_t(_rand(rng, h)), _t(_rand(rng, h))]]
        args, fn = [x, None, None] + ws, trnn.gru_recurrence
    else:
        ws = [[_t(_rand(rng, i + h, 4 * h)), _t(_rand(rng, 2 * h, 4 * h))],
              [_t(_rand(rng, 4 * h)), _t(_rand(rng, 4 * h))]]
        args, fn = [x, None, None, None] + ws, trnn.lstm_recurrence
    attrs = dict(treg.get_op_def(op_type).default_attrs, hidden_size=h,
                 num_layers=l_, dropout_prob=p)
    seed = 0x1234_5678_9ABC
    calls = []
    real = philox.keep_bytes

    def spy(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    philox.keep_bytes = spy
    try:
        got = treg.get_op_def(op_type).lower(
            TCtx(torch.device("cpu"), seed=seed), *args, **attrs)
    finally:
        philox.keep_bytes = real
    assert calls == [(t_, l_, b, h)]
    keep = philox.keep_bytes(philox.words_of(seed), byte_threshold(1 - p),
                             (t_, l_, b, h))
    want = fn(*args, keep, **attrs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert 0.4 < float(keep.float().mean()) < 0.8


@pytest.mark.parametrize("ties", ["none", "inside", "at_the_edge", "zeros"])
def test_beam_search_breaks_ties_as_the_reference(ties):
    """``beam_search``'s best K (one ``topk`` over int64 keys) against the
    reference's ``lax.top_k``: equal candidates go to the lower index,
    inside the K and across the K-th place, -0.0 equal to 0.0."""
    rng = np.random.RandomState(3)
    b, k, v = 3, 4, 7
    scores = rng.randn(b, k, v).astype(np.float32)
    if ties == "inside":
        scores[:, :, 2] = scores[:, :, 5] = 5.0
    elif ties == "at_the_edge":
        scores[...] = -3.0
        scores[:, 1, :3] = 1.0
        scores[:, 3, 4:] = 0.5
    elif ties == "zeros":
        scores = np.round(scores).astype(np.float32)
        scores[scores == 0] = np.where(rng.rand(int((scores == 0).sum()))
                                       < 0.5, -0.0, 0.0)
    pre_ids = np.array([[3, 1, 0, 2]] * b, "int64")
    pre_scores = rng.randn(b, k).astype(np.float32)
    args = (pre_ids, pre_scores, None, scores)
    attrs = {"beam_size": k, "end_id": 1, "level": 0, "is_accumulated": True}
    want = jreg.get_op_def("beam_search").lower(JCtx(mode="eager"),
                                                *map(_j, args), **attrs)
    got = treg.get_op_def("beam_search").lower(TCtx(torch.device("cpu")),
                                               *map(_t, args), **attrs)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 0.0, "beam_search")
