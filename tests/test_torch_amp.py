"""The bf16 AMP policy through the port's entry points
(``contrib.mixed_precision.decorate(opt).minimize(loss)``,
``Executor.run``), re-posing the reference's ``tests/test_amp.py`` and
holding the port against the JAX package on the CPU.

* The reference's own checks, in the port: an MLP under ``decorate``
  trains as its f32 twin does; static loss scaling at 128; dynamic
  scaling grows the scale to exactly 128 after two finite steps and
  backs off to exactly 64 on an overflow; the flag reaches the lowering
  (the product's output is bf16 at run time).
* Programs: decorated programs (no, static and dynamic scaling; BERT_TINY
  and resnet18 as the reference's bench builds them) equal the
  reference's through ``to_dict()``.
* The param carry: ``BlockPlan.carry_names`` equals the reference's
  ``analyze_param_carry`` list on the program each executor runs (its
  optimizer ops fused), for BERT_TINY (every product's weight) and
  resnet18 (none: its L2Decay reads every weight).
* One step of each, op by op, every op fed the reference's inputs (the
  carried weights as bf16 copies, their masters under ``@MASTER``, as
  both executors lay the step out; resnet18 also from the state after
  the reference's first step): every variable the step writes has
  the reference's dtype and its value within one bf16 ulp of the
  tensor's largest value, except the reduction a broadcast
  ``elementwise_add`` grad makes (see ``test_torch_amp_ops.py``), held
  there to one ulp of the exact sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.lowering import BlockPlan as JPlan
from paddle_tpu.core.lowering import run_op as jrun
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.core import Executor, Scope, scope_guard
from paddle_tpu_torch.core.lowering import BlockPlan as TPlan
from paddle_tpu_torch.core.lowering import LowerCtx
from paddle_tpu_torch.core.lowering import run_op as trun
from paddle_tpu_torch.core.registry import get_op_def as tdef
from paddle_tpu_torch.core.registry import lower_attrs
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.utils import unique_name as tun
import test_torch_bert_dropout as tbd
from test_torch_amp_ops import bf16_keys

MASTER = "@MASTER"


# -- the reference's tests/test_amp.py, in the port --------------------------

def mlp(L, opt_mod, decorate, use_amp, loss_scaling=1.0, dynamic=False):
    """The reference test's classifier: fc 16-32 relu, fc 32-4, SGD 0.1;
    ``L``, ``opt_mod`` and ``decorate`` are either package's."""
    x = L.data("x", shape=[16])
    y = L.data("y", shape=[1], dtype="int64")
    h = L.fc(x, 32, act="relu")
    logits = L.fc(h, 4)
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    opt = opt_mod.SGD(0.1)
    if use_amp:
        opt = decorate(opt, init_loss_scaling=loss_scaling,
                       use_dynamic_loss_scaling=dynamic)
    opt.minimize(loss)
    return loss, opt


def mlp_data():
    rng = np.random.RandomState(0)
    c = rng.randn(4, 16).astype("f") * 2
    ys = rng.randint(0, 4, 128)
    xs = (c[ys] + rng.randn(128, 16) * 0.3).astype("f")
    return {"x": xs, "y": ys.reshape(-1, 1).astype("int64")}


def train_mlp(use_amp, steps=60, loss_scaling=1.0):
    main, startup = tfw.Program(), tfw.Program()
    main.random_seed = 5
    with tfw.program_guard(main, startup):
        loss, _opt = mlp(tlayers, topt, tmp.decorate, use_amp, loss_scaling)
    exe = Executor(tfw.CPUPlace())
    feed = mlp_data()
    with scope_guard(Scope()):
        exe.run(startup)
        return [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                for _ in range(steps)]


def test_amp_converges_like_fp32():
    fp32 = train_mlp(False)
    amp = train_mlp(True)
    assert amp[-1] < fp32[0] * 0.3
    assert abs(amp[-1] - fp32[-1]) < 0.1, (amp[-1], fp32[-1])


def test_amp_with_loss_scaling():
    amp = train_mlp(True, loss_scaling=128.0)
    assert amp[-1] < amp[0] * 0.3


def test_dynamic_loss_scaling_backs_off_on_overflow():
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[4])
        h = tlayers.fc(x, 4, bias_attr=False)
        loss = tlayers.mean(h)
        opt = tmp.decorate(topt.SGD(0.1), init_loss_scaling=64.0,
                           use_dynamic_loss_scaling=True,
                           incr_every_n_steps=2, incr_ratio=2.0,
                           decr_ratio=0.5)
        opt.minimize(loss)
    scale_var = opt.get_loss_scaling()
    exe = Executor(tfw.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        ok = np.ones((2, 4), "float32")
        s0, = exe.run(main, feed={"x": ok}, fetch_list=[scale_var])
        s1, = exe.run(main, feed={"x": ok}, fetch_list=[scale_var])
        assert float(s0[0]) == 64.0 and float(s1[0]) == 128.0, (s0, s1)
        bad = np.full((2, 4), np.inf, "float32")
        s2, = exe.run(main, feed={"x": bad}, fetch_list=[scale_var])
        assert float(s2[0]) == 64.0, float(s2[0])


def test_amp_flag_reaches_lowering():
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[4])
        w = tlayers.fc(x, 4, bias_attr=False)
        loss = tlayers.mean(w)
        tmp.decorate(topt.SGD(0.1)).minimize(loss)
    assert main._amp_bf16
    mul = next(op for op in main.global_block().ops if op.type == "mul")
    assert LowerCtx(torch.device("cpu"), mul).amp_bf16()
    exe = Executor(tfw.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        out, lo = exe.run(main, feed={"x": np.ones((2, 4), "f")},
                          fetch_list=[w, loss], return_numpy=False)
    # the product is bf16, and so is the mean over it (jnp.mean keeps a
    # bf16 input's dtype)
    assert out.dtype == torch.bfloat16 and lo.dtype == torch.bfloat16
    # a clone keeps no policy, as the reference's
    assert not main.clone(for_test=True)._amp_bf16


# -- programs ----------------------------------------------------------------

@pytest.mark.parametrize("scaling", ["none", "static", "dynamic"])
def test_decorated_programs_equal_reference(scaling):
    """The decorator's ops in the reference's order: none, static (a
    scale each way) and dynamic (isfinite over every grad, the branchless
    scale update, two assigns)."""
    kw = {"none": {}, "static": {"loss_scaling": 128.0},
          "dynamic": {"loss_scaling": 64.0, "dynamic": True}}[scaling]
    progs = []
    for fw, L, om, un, deco in (
            (fluid, fluid.layers, fluid.optimizer, jun,
             fluid.contrib.mixed_precision.decorate),
            (tfw, tlayers, topt, tun, tmp.decorate)):
        main, startup = fw.Program(), fw.Program()
        with un.guard(), fw.program_guard(main, startup):
            mlp(L, om, deco, True, **kw)
        progs.append((main, startup))
    (jm, js), (tm, ts) = progs
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block().ops]
    assert ("isfinite" in types) == (scaling == "dynamic")
    assert types.count("assign") == (2 if scaling == "dynamic" else 0)


def bert_amp(fw, un, mod, cfg, seq=16, lr=1e-3):
    """BERT pretraining under decorate(Adam): the port's
    ``build_pretrain(amp=True)``; the reference's bench.py builds the same
    program (``_bench_bert_at``: the encoder, the masked-LM head, Adam
    decorated)."""
    main, startup = fw.Program(), fw.Program()
    with un.guard(), fw.program_guard(main, startup):
        if mod is tbert:
            _inputs, loss = tbert.build_pretrain(cfg, seq_len=seq, lr=lr,
                                                 amp=True)
        else:
            L = fluid.layers
            _inputs, seq_out = jbert.bert_encoder(cfg, seq)
            mask_pos = L.data("mask_pos", shape=[1], dtype="int64")
            mask_label = L.data("mask_label", shape=[1], dtype="int64")
            picked = L.gather(L.reshape(seq_out, [-1, cfg.hidden]),
                              mask_pos)
            trans = L.layer_norm(L.fc(picked, cfg.hidden, act="gelu"),
                                 begin_norm_axis=1)
            logits = L.fc(trans, cfg.vocab_size)
            loss = L.mean(L.softmax_with_cross_entropy(logits, mask_label))
            fluid.contrib.mixed_precision.decorate(
                fluid.optimizer.Adam(learning_rate=lr)).minimize(loss)
    return main, startup, loss


def resnet_amp(fw, un, mod, lr=0.01):
    main, startup = fw.Program(), fw.Program()
    with un.guard(), fw.program_guard(main, startup):
        _img, _label, loss, _acc = mod.build_train(
            depth=18, class_dim=10, image_size=32, lr=lr, amp=True)
    return main, startup, loss


def both(model):
    """((jax main, startup, loss), (port main, startup, loss), feed)."""
    if model == "bert_tiny":
        return (bert_amp(fluid, jun, jbert, tbd.tiny(jbert)),
                bert_amp(tfw, tun, tbert, tbd.tiny(tbert)),
                tbd.feed(tbd.tiny(tbert), 4, 16))
    rng = np.random.RandomState(0)
    return (resnet_amp(fluid, jun, jres), resnet_amp(tfw, tun, tres),
            {"img": rng.randn(8, 3, 32, 32).astype("f"),
             "label": rng.randint(0, 10, (8, 1)).astype("int64")})


@pytest.mark.parametrize("model", ["bert_tiny", "resnet18"])
def test_amp_programs_equal_reference(model):
    (jm, js, _jl), (tm, ts, _tl), _feed = both(model)
    assert tm._amp_bf16 and jm._amp_bf16
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()


def fused_plans(model):
    """Both programs with their optimizer ops fused as each executor does
    before its first step, and each package's plan of them (carry on)."""
    (jm, js, jl), (tm, ts, tl), feed = both(model)
    JExecutor(fluid.CPUPlace())._maybe_fuse_optimizers(
        jm, jm.global_block(), list(feed), [jl.name])
    Executor(tfw.CPUPlace())._maybe_fuse_optimizers(tm, list(feed),
                                                    [tl.name])
    assert tm.to_dict() == jm.to_dict()
    jp = JPlan(jm.global_block(), list(feed), [jl.name], allow_carry=True)
    tp = TPlan(tm.global_block(), list(feed), [tl.name], allow_carry=True)
    return (jm, js, jl, jp), (tm, ts, tl, tp), feed


@pytest.mark.parametrize("model", ["bert_tiny", "resnet18"])
def test_carry_names_equal_reference(model):
    (jm, _js, jl, jp), (tm, _ts, tl, tp), feed = fused_plans(model)
    assert tp.carry_names == jp.carry_names
    blk = tm.global_block()
    fused = [op.type for op in blk.ops
             if op.type in ("fused_adam", "fused_momentum")]
    if model == "bert_tiny":
        # every product's weight: q, k, v, out, ffn1, ffn2 of 2 layers and
        # the head's two fc weights
        assert len(tp.carry_names) == 14 and fused == ["fused_adam"]
        assert all(n.endswith("_w") or n.startswith("fc_")
                   for n in tp.carry_names)
    else:
        assert tp.carry_names == []     # L2Decay's scale op reads them
        assert fused == ["fused_momentum"]
    # unfused: the same decision on the program as built
    (jm2, _, jl2), (tm2, _, tl2), _ = both(model)
    assert TPlan(tm2.global_block(), list(feed), [tl2.name],
                 allow_carry=True).carry_names == JPlan(
        jm2.global_block(), list(feed), [jl2.name],
        allow_carry=True).carry_names
    # a fetched weight is not carried, in either
    if model == "bert_tiny":
        w = tp.carry_names[0]
        assert w not in TPlan(tm.global_block(), list(feed), [tl.name, w],
                              allow_carry=True).carry_names
        assert w not in JPlan(jm.global_block(), list(feed), [jl.name, w],
                              allow_carry=True).carry_names


# -- one step, op by op ------------------------------------------------------

def _t(v):
    """A jax value as the torch tensor of the same dtype and bits."""
    if v.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(v))


def _bias_grad(op, tenv_in):
    """Names of the outputs of ``op`` that are a broadcast elementwise_add
    grad's reduction, with the cotangent and the summed dims."""
    if op.type != "elementwise_add_grad" or not op.output("X@Y") \
            or not op.output("X@Y")[0]:
        return {}
    x = tenv_in[op.input("X")[0]]
    y = tenv_in[op.input("Y")[0]]
    if tuple(x.shape) == tuple(y.shape):
        return {}
    out = tenv_in[op.input("Out@Out")[0]]
    dout = tenv_in[op.input("GRAD@Out")[0]].to(out.dtype).float().numpy()
    keep = y.dim()  # fluid's axis -1: y aligns with x's trailing dims
    return {op.output("X@Y")[0]: (dout, tuple(range(x.dim() - keep)))}


@pytest.mark.parametrize("model,after", [("bert_tiny", 0), ("resnet18", 0),
                                         ("resnet18", 1)])
def test_every_op_of_an_amp_step_matches_the_reference(monkeypatch, model,
                                                       after):
    """One training step of the fused program, op by op, each op of the
    port fed the reference's inputs (the dtype of every variable the step
    writes, and its value; see the module's docstring), from the initial
    state and, for resnet18 (whose chained steps part, see
    ``test_torch_amp_train.py``), from the reference's state after its
    first step."""
    tbd.patch_masks(monkeypatch)
    (jm, js, jl, jp), (tm, _ts, _tl, tp), feed = fused_plans(model)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars()
             if v.persistable and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        for _ in range(after):
            exe.run(jm, feed=feed, fetch_list=[jl])
        init = {n: jnp.asarray(np.array(scope.find_var(n).get_tensor()
                                        .numpy())) for n in names}
    jenv = dict(init)
    jenv.update({n: jnp.asarray(v) for n, v in feed.items()})
    for n in jp.carry_names:     # the executors' layout of a carried step
        jenv[n + MASTER] = jenv[n]
        jenv[n] = jenv[n].astype(jnp.bfloat16)
    carry = {n: _t(jenv[n]) for n in tp.carry_names}
    key = jax.random.key(0)
    checked = 0
    for i, (jo, to) in enumerate(zip(jm.global_block().ops,
                                     tm.global_block().ops)):
        if jo.type in ("feed", "fetch"):
            continue
        wanted = list(to.input_arg_names) + [
            p + MASTER for p in to.input("Param")]
        tenv = {n: _t(jenv[n]) for n in wanted if n in jenv}
        sums = _bias_grad(to, tenv)
        jrun(jo, jenv, jax.random.fold_in(key, i))
        trun(to, tdef(to.type), lower_attrs(to.attrs), tenv,
             torch.device("cpu"), 1, dict(carry), set())
        for n in to.output_arg_names:
            # Seed: the two packages' key words (masks are shared)
            if not n or n not in jenv or n in to.output("Seed"):
                continue
            j, t = jenv[n], tenv[n]
            want = str(j.dtype)
            if want == "int32" and t.dtype == torch.int64:
                want = "int64"      # the reference's jax runs without x64
            assert str(t.dtype).replace("torch.", "") == want, \
                (to.type, n, t.dtype, j.dtype)
            if not jnp.issubdtype(j.dtype, jnp.floating):
                continue
            a = np.asarray(j.astype(jnp.float32))
            b = t.float().numpy()
            if n in sums:
                cot, dims = sums[n]
                exact = cot.astype(np.float64).sum(axis=dims).reshape(
                    b.shape)
                d = np.abs(bf16_keys(b) - bf16_keys(exact.astype(
                    np.float32)))
                assert d.max() <= 1, (to.type, n, d.max())
            else:
                scale = max(float(np.abs(a).max()), 1e-30)
                assert float(np.abs(a - b).max()) <= 2 ** -7 * scale, \
                    (i, to.type, n, float(np.abs(a - b).max()) / scale)
            checked += 1
    assert checked > (150 if model == "bert_tiny" else 250)
