"""Transformer NMT through the PyTorch port's entry points on the CPU:
train on the synthetic translation task, then beam-decode.

* The port alone: the reference's ``test_transformer_trains_and_beam_decodes``
  (``tests/test_transformer.py``) re-posed for the port.  A 1+1-layer
  model (d_model 32, vocabulary 24, label smoothing 0.1, noam warmup 100)
  trains 6 epochs of the reference's ``datasets.wmt16`` (reverse and
  shift, batches of 64 from ``reader_decorator.batch``) through
  ``build_train`` -> ``Adam.minimize`` -> ``Executor.run``: the last loss
  is under half the first, and ``build_beam_infer`` (beam 2) decodes
  held-out pairs with the top beam's token accuracy above 0.6 and the
  scores sorted across beams.
* Beam decode against the JAX package from the weights that training
  left (beam 4, 10 steps, one batch of 16 held-out sources): each row's
  ``beam_search`` steps are walked in both, selected ids and parents
  equal and selected scores to 1e-4, until a step where the two part;
  parting is allowed only where the reference's best K + 1 candidates
  lie within 1e-5 of each other (``chip_smoke.beam_margins``: a near-tie
  that f32 in another summation order may break either way); a row that
  never parts has the reference's sequences, and its scores to 1e-4.
  Most rows never part (trained weights separate the candidates).
"""

import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu as fluid
from paddle_tpu.datasets import wmt16
from paddle_tpu.models import transformer as jtr
from paddle_tpu.reader_decorator import batch as rbatch
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                   scope_guard)
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.utils import unique_name as tun

VOCAB = 24
SRC_LEN, TRG_LEN = 8, 10
EPOCHS = 6
TIE = 1e-5
SCORE_ATOL = 1e-4


def cfg(mod):
    return mod.TransformerConfig(
        src_vocab=VOCAB, trg_vocab=VOCAB, d_model=32, heads=2,
        enc_layers=1, dec_layers=1, ffn=64, max_len=32, dropout=0.0,
        label_smooth=0.1)


def held_out_batch():
    b = next(rbatch(wmt16.test(VOCAB, VOCAB, min_len=3, max_len=7), 16,
                    drop_last=True)())
    return ttr.pad_batch(b, SRC_LEN, TRG_LEN)


def beam_program(mod, fw, un, k):
    main, startup = fw.Program(), fw.Program()
    with un.guard(), fw.program_guard(main, startup):
        _src, ids, scores = mod.build_beam_infer(cfg(mod), SRC_LEN,
                                                 beam_size=k,
                                                 max_out_len=TRG_LEN)
    return main, startup, ids, scores


@pytest.fixture(scope="module")
def trained():
    """Losses of the port's training run and its parameters after."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        _feeds, loss = ttr.build_train(cfg(ttr), SRC_LEN, TRG_LEN,
                                       warmup=100)
    exe, scope = Executor(tfw.CPUPlace()), Scope()
    losses = []
    with scope_guard(scope):
        exe.run(startup)
        for _ep in range(EPOCHS):
            for b in rbatch(wmt16.train(VOCAB, VOCAB, min_len=3, max_len=7),
                            64, drop_last=True)():
                src, trg, nxt, w = ttr.pad_batch(b, SRC_LEN, TRG_LEN)
                lo, = exe.run(main, feed={
                    "src_ids": src, "trg_ids": trg, "trg_next": nxt,
                    "trg_weight": w}, fetch_list=[loss])
                losses.append(float(lo.ravel()[0]))
    params = {v.name: scope.find_var(v.name).get_tensor().numpy()
              for v in main.list_vars() if isinstance(v, tfw.Parameter)}
    return losses, params


def test_transformer_trains_and_beam_decodes(trained):
    losses, params = trained
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    main, _startup, seq_ids, seq_scores = beam_program(ttr, tfw, tun, 2)
    src, _trg, nxt, w = held_out_batch()
    ids, scores = Executor(tfw.CPUPlace()).run(
        main, feed={"src_ids": src}, fetch_list=[seq_ids, seq_scores],
        scope=scope_from_numpy(Scope(), params, "cpu", program=main))
    assert ids.shape == (16, 2, TRG_LEN)
    mask = w > 0
    token_acc = float((ids[:, 0, :][mask] == nxt[mask]).mean())
    assert token_acc > 0.6, token_acc
    assert (scores[:, 0] + 1e-6 >= scores[:, 1]).all()


def probe(main):
    """Each beam_search op's inputs and outputs, in order."""
    names = []
    for op in main.global_block().ops:
        if op.type == "beam_search":
            names += [op.input(s)[0] for s in ("pre_ids", "pre_scores",
                                               "scores")]
            names += [op.output(s)[0] for s in (
                "selected_ids", "selected_scores", "parent_idx")]
    return names


def test_beam_decode_matches_reference(trained):
    _losses, params = trained
    k = 4
    src = held_out_batch()[0]
    jm, js, jids, jscores = beam_program(jtr, fluid, jun, k)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        for n, a in params.items():
            scope.find_var(n).get_tensor().set(a)
        want = [np.asarray(a) for a in exe.run(
            jm, feed={"src_ids": src},
            fetch_list=[jids, jscores] + probe(jm))]
    tm, _ts, tids, tscores = beam_program(ttr, tfw, tun, k)
    got = Executor(tfw.CPUPlace()).run(
        tm, feed={"src_ids": src}, fetch_list=[tids, tscores] + probe(tm),
        scope=scope_from_numpy(Scope(), params, "cpu", program=tm))
    at = lambda run, t, i: run[2 + 6 * t + i]  # noqa: E731
    whole = 0
    for b in range(len(src)):
        for t in range(TRG_LEN):
            if not all(np.array_equal(at(got, t, i)[b],
                                      at(want, t, i)[b]) for i in (3, 5)):
                margin = cs.beam_margins(at(want, t, 0), at(want, t, 1),
                                         at(want, t, 2), k, ttr.EOS)[b]
                assert margin <= TIE, (b, t, margin)
                break
            np.testing.assert_allclose(at(got, t, 4)[b], at(want, t, 4)[b],
                                       atol=SCORE_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got[0][b], want[0][b])
            np.testing.assert_allclose(got[1][b], want[1][b],
                                       atol=SCORE_ATOL, rtol=0)
            whole += 1
    assert whole >= len(src) // 2, whole
