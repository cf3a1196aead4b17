"""The comparison ``chip_smoke.py``'s NMT phase runs card against CPU,
exercised on the CPU alone at ``TRANSFORMER_TINY`` (batch 4, 8 + 8
tokens, 3 steps).

* ``pinned_relus``: a run pinned to its own relu inputs' signs is
  bitwise the run itself; pinned to the opposite signs it moves the
  losses, moments and parameters past ``nmt_gaps``' limits.
* ``upstream_params``: the encoder's relu is reached from the source
  embedding and the encoder layer's attention, LayerNorm and fc1 only;
  the decoder's from every parameter but those after its FFN.
* ``nmt_gaps``: the step counter one step late misses the learning-rate
  and parameter limits, as the phase's planted fault must.
"""

import numpy as np
import pytest

import chip_smoke as cs
from paddle_tpu_torch import framework
from paddle_tpu_torch.core import Executor, Scope, scope_guard, scope_to_numpy
from paddle_tpu_torch.models import transformer as tr

LEN = 8


@pytest.fixture(scope="module")
def tiny():
    cfg = tr.TRANSFORMER_TINY
    main_p, startup = framework.Program(), framework.Program()
    startup.random_seed = 13
    with framework.program_guard(main_p, startup):
        _feeds, loss = tr.build_train(cfg, LEN, LEN, warmup=cs.NMT_WARMUP)
    lr_name = next(op.input("LearningRate")[0]
                   for op in main_p.global_block().ops if op.type == "adam")
    sc = Scope()
    with scope_guard(sc):
        Executor(framework.CPUPlace()).run(startup)
        init = scope_to_numpy(sc, main_p)
    return cfg, main_p, loss, lr_name, init


def steps(tiny, monkeypatch, state=None, pin=None):
    cfg, main_p, loss, lr_name, init = tiny
    monkeypatch.setattr(cs, "NMT_LEN", LEN)
    feed = cs.nmt_feed(np.random.RandomState(1), cfg, 4, pad=True)
    return cs.nmt_check_steps(main_p, loss, lr_name,
                              init if state is None else state, feed,
                              framework.CPUPlace(), pin=pin)


def test_pinned_relus_follow_the_given_signs(tiny, monkeypatch):
    cfg, init = tiny[0], tiny[4]
    own = steps(tiny, monkeypatch)
    same = steps(tiny, monkeypatch, pin=own[4])
    assert own[0] == same[0]
    for n in own[3]:
        np.testing.assert_array_equal(own[3][n], same[3][n])
    for i in (0, 1):
        for n in own[2][i]:
            np.testing.assert_array_equal(own[2][i][n], same[2][i][n])
    flipped = steps(tiny, monkeypatch,
                    pin=[[-x for x in step] for step in own[4]])
    assert not cs.missed(cs.nmt_gaps(own, same, init, set(), cfg))
    missed = cs.missed(cs.nmt_gaps(own, flipped, init, set(), cfg))
    assert {"losses", "moments after the first step",
            "parameters"} <= set(missed), missed


def test_upstream_params_of_each_relu(tiny):
    main_p = tiny[1]
    enc, dec = [op.input("X")[0] for op in main_p.global_block().ops
                if op.type == "relu"]
    assert cs.upstream_params(main_p, [enc]) == {
        "src_emb", "enc0_att_ln_s", "enc0_att_ln_b", "enc0_fc1_w",
        "enc0_fc1_b"} | {"enc0_self_%s_%s" % (p, k) for p in "qkvo"
                         for k in "wb"}
    params = {v.name for v in main_p.list_vars()
              if isinstance(v, framework.Parameter)}
    after = {"dec0_fc2_w", "dec0_fc2_b", "dec0_ffn_ln_s", "dec0_ffn_ln_b",
             "out_proj_w", "out_proj_b"}
    assert cs.upstream_params(main_p, [dec]) == params - after


def test_the_late_counter_is_seen(tiny, monkeypatch):
    cfg, init = tiny[0], tiny[4]
    late = dict(init)
    late["@LR_DECAY_COUNTER@"] = init["@LR_DECAY_COUNTER@"] + 1
    sound = steps(tiny, monkeypatch)
    gaps = cs.nmt_gaps(steps(tiny, monkeypatch, state=late), sound, init,
                       set(), cfg)
    assert gaps["noam lr"][0] == pytest.approx(1.0, rel=1e-5)
    assert {"noam lr", "parameters"} <= set(cs.missed(gaps))
