"""Gradient clipping, and the scalar ops the clips and schedules build
from, in the PyTorch port held against the JAX package on the CPU.

* Ops: ``clip``, ``clip_by_norm`` (a norm above and below its limit),
  ``squared_l2_norm``, ``sqrt``, ``exp``, ``floor``, ``ceil``, ``cos``,
  ``sign``, ``logical_and``, ``less_than`` and ``greater_equal``, the
  port's lowering against the reference's on numpy-seeded inputs: floats
  to OP_RTOL of the tensor's largest value, masks exactly.
* Programs: the MNIST MLP under Adam with each clip of ``CLIPS`` set by
  ``set_gradient_clip`` (by value, by norm, by global norm) or as one
  parameter's own ``gradient_clip`` attr: main and startup programs
  equal the reference's through ``to_dict()``, the global norm's ops
  under the Backward role with the reference's names (``<grad>@sq_l2``,
  ``global_norm@<group>@var``); the port's ``grad_clip=`` argument builds
  the same program (the reference's raises a TypeError); after the
  fusion pass the Adam group over the clipped gradients is one
  ``fused_adam`` in both.
* Training: 5 steps of each clip on 5 batches of 64, the port's each from
  the reference's state before it: losses to LOSS_ATOL, every parameter
  and moment to STATE_RTOL of its largest value but at most FLIP_SHARE
  of its elements (Adam's first step divides by |g|, so a weight whose
  gradient cancels to rounding noise moves by a whole step on its sign;
  ``test_torch_optimizers.py``).
* BERT_TINY (dropout 0, seq 16, batch 4) under LAMB's recipe: ``Lamb``
  with weight decay 0.01 but not on the LayerNorm parameters or biases
  (``models.bert.no_weight_decay``), ``GradientClipByGlobalNorm(1.0)``,
  a linear warmup over 2 steps into a polynomial decay: 5 chained steps
  from the reference's initial state give the reference's losses to
  BERT_LOSS_ATOL, the learning rates to 1e-6, and the global norm the
  clip divides by, fetched each step, to BERT_NORM_RTOL.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.utils import unique_name as tun

OP_RTOL = 1e-6
STEPS = 5
BATCH = 64
LOSS_ATOL = 1e-5
STATE_RTOL = 1e-4
FLIP_SHARE = 1e-3
BERT_SEQ, BERT_BATCH = 16, 4
BERT_LOSS_ATOL = 1e-4
BERT_NORM_RTOL = 1e-4

J = types.SimpleNamespace(fw=fluid, layers=fluid.layers, opt=fluid.optimizer,
                          clip=fluid.clip, un=jun, mlp=jmnist.build_mlp,
                          bert=jbert)
T = types.SimpleNamespace(fw=tfw, layers=tlayers, opt=topt, clip=tclip,
                          un=tun, mlp=tmnist.build_mlp, bert=tbert)


# -- ops -------------------------------------------------------------------


def _op_cases():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 7).astype(np.float32)
    pos = (rng.rand(6, 7) * 4 + 0.01).astype(np.float32)
    a, b = rng.randn(5) > 0, rng.randn(5) > 0
    return [("clip", [x, None, None], {"min": -0.5, "max": 0.7}),
            ("clip_by_norm", [x], {"max_norm": 1.0}),
            ("clip_by_norm", [x], {"max_norm": 100.0}),
            ("squared_l2_norm", [x], {}),
            ("sqrt", [pos], {}), ("exp", [x], {}), ("floor", [x * 3], {}),
            ("ceil", [x * 3], {}), ("cos", [x * 3], {}), ("sign", [x], {}),
            ("logical_and", [a, b], {}),
            ("less_than", [x, x.T.reshape(6, 7)], {}),
            ("greater_equal", [x, np.float32(0.1) * np.ones_like(x)], {})]


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", range(len(OP_CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_op_matches_reference(case):
    op_type, args, attrs = OP_CASES[case]
    want = jreg.get_op_def(op_type).lower(
        JCtx(mode="eager"),
        *[None if a is None else jnp.asarray(a) for a in args], **attrs)
    got = treg.get_op_def(op_type).lower(
        TCtx(torch.device("cpu")),
        *[None if a is None else torch.from_numpy(np.array(a))
          for a in args], **attrs)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=OP_RTOL * np.abs(want).max())


def test_clip_by_norm_scales_only_above_the_limit():
    x = torch.tensor([3.0, 4.0])
    op = treg.get_op_def("clip_by_norm").lower
    ctx = TCtx(torch.device("cpu"))
    torch.testing.assert_close(op(ctx, x, max_norm=1.0),
                               torch.tensor([0.6, 0.8]))
    torch.testing.assert_close(op(ctx, x, max_norm=10.0), x)


# -- programs and training ----------------------------------------------------

CLIPS = {
    "value": lambda c: c.GradientClipByValue(0.01),
    "norm": lambda c: c.GradientClipByNorm(0.1),
    "global_norm": lambda c: c.GradientClipByGlobalNorm(0.5),
}


def build(m, kind, attr=False, argument=False):
    """(main, startup, loss) of the MLP under Adam(0.002) with the clip
    ``kind``: process-wide (``set_gradient_clip``), the first layer's
    weight's own attr (``attr``), or the optimizer's ``grad_clip=``
    (``argument``, the port only)."""
    main, startup = m.fw.Program(), m.fw.Program()
    startup.random_seed = 5
    clip = CLIPS[kind](m.clip)
    try:
        with m.un.guard(), m.fw.program_guard(main, startup):
            loss = m.mlp()[3]
            if attr:
                main.global_block().var("fc_0.w_0").gradient_clip_attr = clip
            elif argument:
                m.opt.Adam(0.002, grad_clip=clip).minimize(loss)
                return main, startup, loss
            else:
                m.clip.set_gradient_clip(clip)
            m.opt.Adam(0.002).minimize(loss)
    finally:
        m.clip.set_gradient_clip(None)
    return main, startup, loss


@pytest.mark.parametrize("kind", sorted(CLIPS))
@pytest.mark.parametrize("how", ["set_gradient_clip", "attr", "grad_clip="])
def test_clip_programs_equal_reference(kind, how):
    jm, js, _ = build(J, kind, attr=how == "attr")
    tm, ts, _ = build(T, kind, attr=how == "attr",
                      argument=how == "grad_clip=")
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    ops = tm.global_block().ops
    if kind == "global_norm" and how != "attr":
        sq = [op for op in ops if op.type == "squared_l2_norm"]
        assert len(sq) == 6
        assert sq[0].output("Out") == [sq[0].input("X")[0] + "@sq_l2"]
        assert all(op.attr("op_role") == tfw.OpRole.Backward for op in sq)
        assert any(op.output("Out") == ["global_norm@default_group@var"]
                   for op in ops)
    jir.apply_pass("fuse_optimizer_ops_pass", jm, None)
    tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
    assert tm.to_dict() == jm.to_dict()
    fused, = [op for op in tm.global_block().ops if op.type == "fused_adam"]
    clipped = set(fused.input("Grad")) - {n + "@GRAD" for n in
                                          fused.input("Param")}
    assert len(clipped) == (1 if how == "attr" else 6)


def _feeds():
    rng = np.random.RandomState(0)
    centres = rng.randn(10, 784).astype(np.float32)
    out = []
    for _ in range(STEPS):
        label = rng.randint(0, 10, (BATCH, 1)).astype(np.int64)
        out.append({"img": (centres[label.ravel()] + rng.randn(BATCH, 784))
                    .astype(np.float32), "label": label})
    return out


def _persistables(main):
    return [v.name for v in main.list_vars()
            if v.persistable and not v.is_data]


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_mlp_under_each_clip_trains_as_the_reference(kind):
    jm, js, jloss = build(J, kind)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = _persistables(jm)

    def state():
        return {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}

    with fluid.scope_guard(scope):
        exe.run(js)
        states, want = [state()], []
        for f in _feeds():
            want.append(float(np.asarray(exe.run(jm, feed=f,
                                                 fetch_list=[jloss])[0])
                              .ravel()[0]))
            states.append(state())
    tm, _ts, tloss = build(T, kind)
    texe, got = Executor(tfw.CPUPlace()), []
    for step, (before, f) in enumerate(zip(states, _feeds())):
        sc = scope_from_numpy(Scope(), before, "cpu", program=tm)
        got.append(float(texe.run(tm, feed=f, fetch_list=[tloss],
                                  scope=sc)[0].ravel()[0]))
        for n, w in states[step + 1].items():
            g = sc.find_var(n).get_tensor().numpy()
            assert np.isfinite(g).all(), (step, n)
            d = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
            assert d.max() <= STATE_RTOL or (d > STATE_RTOL).mean() \
                <= FLIP_SHARE, (step, n, float(d.max()))
    assert any(op.type == "fused_adam" for op in tm.global_block().ops)
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert want[-1] < want[0]


# -- BERT_TINY under LAMB's recipe ---------------------------------------------


def bert_lamb(m):
    """(main, startup, loss, lr, the global norm) of BERT_TINY's
    pretraining under Lamb, the global-norm clip and warmup into a
    polynomial decay."""
    main, startup = m.fw.Program(), m.fw.Program()
    startup.random_seed = 5
    cfg = m.bert.BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                            ffn=128, max_pos=64, dropout=0.0)
    try:
        with m.un.guard(), m.fw.program_guard(main, startup):
            L = m.layers
            inputs, seq_out = m.bert.bert_encoder(cfg, BERT_SEQ, False)
            mask_pos = L.data("mask_pos", shape=[1], dtype="int64")
            mask_label = L.data("mask_label", shape=[1], dtype="int64")
            picked = L.gather(L.reshape(seq_out, [-1, cfg.hidden]), mask_pos)
            trans = L.layer_norm(L.fc(picked, cfg.hidden, act="gelu"),
                                 begin_norm_axis=1)
            logits = L.fc(trans, cfg.vocab_size)
            loss = L.mean(L.softmax_with_cross_entropy(logits, mask_label))
            lr = L.linear_lr_warmup(L.polynomial_decay(1e-3, 10, 0.0), 2,
                                    0.0, 1e-3)
            m.clip.set_gradient_clip(m.clip.GradientClipByGlobalNorm(1.0))
            m.opt.Lamb(lr, lamb_weight_decay=0.01,
                       exclude_from_weight_decay_fn=tbert.no_weight_decay
                       ).minimize(loss)
    finally:
        m.clip.set_gradient_clip(None)
    norm, = [op.output("Out")[0] for op in main.global_block().ops
             if op.type == "sqrt"]
    return main, startup, loss, lr, norm


def _bert_feed(seed=0):
    rng = np.random.RandomState(seed)
    n_mask = int(BERT_BATCH * BERT_SEQ * 0.15)
    return {"src_ids": rng.randint(0, 1024, (BERT_BATCH, BERT_SEQ, 1))
            .astype(np.int64),
            "pos_ids": np.tile(np.arange(BERT_SEQ).reshape(1, BERT_SEQ, 1),
                               (BERT_BATCH, 1, 1)).astype(np.int64),
            "sent_ids": rng.randint(0, 2, (BERT_BATCH, BERT_SEQ, 1))
            .astype(np.int64),
            "input_mask": np.ones((BERT_BATCH, BERT_SEQ, 1), np.float32),
            "mask_pos": rng.randint(0, BERT_BATCH * BERT_SEQ, n_mask)
            .astype(np.int64),
            "mask_label": rng.randint(0, 1024, (n_mask, 1)).astype(np.int64)}


def test_bert_tiny_under_lamb_trains_as_the_reference():
    jm, js, jloss, jlr, jnorm = bert_lamb(J)
    tm, _ts, tloss, tlr, tnorm = bert_lamb(T)
    assert tm.to_dict() == jm.to_dict()
    decays = {op.input("Param")[0]: op.attr("weight_decay")
              for op in tm.global_block().ops if op.type == "lamb"}
    assert decays["layer_0_attn_q_w"] == 0.01
    assert decays["fused_dropout_add_ln_0.w_0"] == 0.0
    assert decays["fc_0.b_0"] == 0.0
    feed = _bert_feed()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in _persistables(jm)}
        want = np.array([[float(np.asarray(o).ravel()[0]) for o in
                          exe.run(jm, feed=feed,
                                  fetch_list=[jloss, jlr, jnorm])]
                         for _ in range(STEPS)])
    texe = Executor(tfw.CPUPlace())
    tscope = scope_from_numpy(Scope(), init, "cpu", program=tm)
    got = np.array([[float(o.ravel()[0]) for o in
                     texe.run(tm, feed=feed, fetch_list=[tloss, tlr, tnorm],
                              scope=tscope)] for _ in range(STEPS)])
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=BERT_LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=BERT_NORM_RTOL)
    assert list(np.round(got[:, 1] * 1e4, 3)) == [0.0, 5.0, 8.0, 7.0, 6.0]
    assert got[-1, 0] < got[0, 0]
