"""ResNet through the PyTorch port's Program front end, held against the
JAX package on the CPU: programs, the predictor's passes, the predictor's
outputs and training steps, for two programs:

* the bundled ResNet (``models/resnet.py``: conv2d + batch_norm pairs,
  Momentum with L2Decay(1e-4)), at ResNet-18 depth, 32x32 images, 10
  classes, as ``bundled_builders()["resnet18"]`` builds it;
* a trunk of the same architecture with each conv + batch-norm pair
  written as ``layers.conv2d_bn_relu`` (``trunk`` below, one helper for
  both packages), run with ``FLAGS_use_pallas_conv_block`` on: the
  reference's kernels in interpret mode, the port's kernel wrappers on
  their plain versions.

Tolerances (f32, both packages on the CPU, other summation orders):
predictor outputs (logits ~1) to 1e-4; training losses to 1e-4 over 5
steps.  Training runs Momentum at lr 0.01 on a batch of 8: at the
bundled lr 0.1 and batch 4, the batch norms over 1x1 maps (ResNet-18's
last stage at 32x32) amplify two summation orders into a loss gap of
1e-3 by step 2 and chaos after, so that setting is held for one step
(loss 1e-5, velocities 1e-3 of their largest value)."""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import ir as jir
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import AnalysisPredictor as JPredictor
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
from paddle_tpu.pallas_kernels import adoption
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.utils import unique_name as tun

FLAG = "FLAGS_use_pallas_conv_block"
IMG = 32
CLASSES = 10
BATCH = 8
STEPS = 5
LR = 0.01
PRED_ATOL = 1e-4
LOSS_ATOL = 1e-4


def trunk(L, img, width=8, counts=(1, 1, 1), class_dim=CLASSES,
          is_test=False):
    """ResNet's architecture (a 7x7 stride-2 stem, a 3x3 max pool, basic
    blocks whose first in a stage strides by 2, global average pool, fc)
    with every conv + batch norm one ``conv2d_bn_relu``; ``L`` is either
    package's ``layers``."""

    def cbr(x, f, k, s, act="relu"):
        return L.conv2d_bn_relu(x, f, k, stride=s, padding=(k - 1) // 2,
                                act=act, is_test=is_test)

    x = cbr(img, width, 7, 2)
    x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    for stage, n in enumerate(counts):
        f = width * 2 ** stage
        for i in range(n):
            s = 2 if (i == 0 and stage > 0) else 1
            y = cbr(cbr(x, f, 3, s), f, 3, 1, act=None)
            short = cbr(x, f, 1, s, act=None) if (s != 1 or x.shape[1] != f) \
                else x
            x = L.relu(L.elementwise_add(y, short))
    x = L.pool2d(x, pool_type="avg", global_pooling=True)
    return L.fc(x, class_dim)


def _trunk_train(L, opt_mod, reg_mod, is_test=False):
    img = L.data("img", shape=[3, IMG, IMG])
    label = L.data("label", shape=[1], dtype="int64")
    logits = trunk(L, img, is_test=is_test)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    if not is_test:
        opt_mod.Momentum(learning_rate=LR, momentum=0.9,
                         regularization=reg_mod.L2Decay(1e-4)).minimize(loss)
    return img, logits, loss


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setenv("PADDLE_PALLAS_INTERPRET", "1")
    saved_j, saved_t = fluid.get_flags([FLAG]), tflags.get_flags([FLAG])
    adoption.reset()
    fluid.set_flags({FLAG: True})
    tflags.set_flags({FLAG: True})
    yield
    fluid.set_flags(saved_j)
    tflags.set_flags(saved_t)
    adoption.reset()


def _resnet18(L, res, is_test, lr):
    """``build_train`` in training; at is_test the inference program of
    the same net (its logits)."""
    if not is_test:
        img, _l, loss, _a = res.build_train(depth=18, class_dim=CLASSES,
                                            image_size=IMG, lr=lr)
        return img, None, loss
    img = L.data("img", shape=[3, IMG, IMG])
    return img, res.resnet(img, CLASSES, 18, is_test=True), None


def _build_fns(model, is_test=False, lr=LR):
    """(JAX build function, port build function), each -> (img, logits or
    None, loss or None)."""
    if model == "resnet18":
        return (lambda: _resnet18(fluid.layers, jres, is_test, lr),
                lambda: _resnet18(tlayers, tres, is_test, lr))
    return (lambda: _trunk_train(fluid.layers, fluid.optimizer,
                                 fluid.regularizer, is_test),
            lambda: _trunk_train(tlayers, topt, treg, is_test))


def _programs(model, is_test=False, lr=LR):
    jb, tb = _build_fns(model, is_test, lr)
    jm, js = fluid.Program(), fluid.Program()
    js.random_seed = 5
    with jun.guard(), fluid.program_guard(jm, js):
        jout = jb()
    tm, ts = tfw.Program(), tfw.Program()
    ts.random_seed = 5
    with tun.guard(), tfw.program_guard(tm, ts):
        tout = tb()
    return (jm, js, jout), (tm, ts, tout)


# -- programs 

@pytest.mark.parametrize("model", ["resnet18", "trunk"])
@pytest.mark.parametrize("which", ["main", "startup", "fused main"])
def test_training_programs_equal_reference(model, which):
    (jm, js, _j), (tm, ts, _t) = _programs(model)
    if which == "fused main":
        jir.apply_pass("fuse_optimizer_ops_pass", jm, None)
        tir.apply_pass("fuse_optimizer_ops_pass", tm, None)
        ops = tm.global_block().ops
        assert sum(op.type == "fused_momentum" for op in ops) == 1
        assert all(len(tm.global_block().var(op.input("Param")[0]).shape)
                   == 4 for op in ops if op.type == "momentum")
    got, want = (ts, js) if which == "startup" else (tm, jm)
    assert got.to_dict() == want.to_dict()


def test_resnet50_op_surface():
    """ResNet-50: 53 conv + batch-norm pairs, 161 parameters of which the
    53 filters keep their own momentum ops and 108 fuse into one."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        tres.build_train(depth=50)
    tir.apply_pass("fuse_optimizer_ops_pass", main, None)
    types = [op.type for op in main.global_block().ops]
    assert types.count("conv2d") == 53 and types.count("batch_norm") == 53
    assert types.count("momentum") == 53
    fused, = [op for op in main.global_block().ops
              if op.type == "fused_momentum"]
    assert len(fused.input("Param")) == 108
    n = sum(int(np.prod(v.shape)) for v in main.list_vars()
            if isinstance(v, tfw.Parameter))
    assert n == 25557032   # ResNet-50 v1.5, 1000 classes


def test_layouts_and_amp_raise():
    """NHWC raises; ``amp=True`` (which raised before the bf16 AMP policy
    was ported) builds the decorated program: flagged, and equal to the
    reference's (``tests/test_torch_amp.py`` holds it through
    ``to_dict()``)."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        with pytest.raises(NotImplementedError, match="NCHW"):
            tres.build_train(depth=18, data_format="NHWC")
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        tres.build_train(depth=18, amp=True)
    assert main._amp_bf16


# -- the predictor 

def _save_jax(model, dirname, seed=5):
    """The JAX package builds the inference program, runs its startup and
    saves the directory; running statistics are made non-trivial first
    (a few training steps would do the same), so the folds matter."""
    (jm, js, (img, logits, _loss)), _port = _programs(model, is_test=True)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    rng = np.random.RandomState(seed)
    with fluid.scope_guard(scope):
        exe.run(js)
        for v in jm.list_vars():
            if v.persistable and v.name.endswith((".mean", ".var")):
                t = scope.find_var(v.name).get_tensor()
                shape = np.asarray(t.numpy()).shape
                val = rng.uniform(0.5, 1.5, shape) if v.name.endswith(
                    ".var") else rng.randn(*shape) * 0.1
                t.set(val.astype(np.float32), fluid.CPUPlace())
        fluid.save_inference_model(dirname, [img.name], [logits], exe,
                                   main_program=jm)
    return dirname


def _predictors(dirname):
    jcfg = JConfig(dirname)
    jcfg.disable_gpu()
    tcfg = AnalysisConfig(dirname)
    tcfg.disable_gpu()
    return JPredictor(jcfg), AnalysisPredictor(tcfg)


def _op_dicts(program):
    return [op.to_dict() for op in program.global_block().ops]


@pytest.mark.parametrize("model", ["resnet18", "trunk"])
def test_predictor_matches_reference(kernel_route, tmp_path, model):
    """Both predictors load the reference's directory with ir_optim on:
    the same rewritten program (conv_bn_fuse, fc_fuse, the add + relu
    fusion), the same folded weights, and the same logits."""
    dirname = _save_jax(model, str(tmp_path / model))
    jp, tp = _predictors(dirname)
    assert _op_dicts(tp.program()) == _op_dicts(jp.program())
    types = {op.type for op in tp.program().global_block().ops}
    assert "batch_norm" not in types and "fc" in types
    assert "fused_elemwise_activation" in types
    for n in (v.name for v in tp.program().list_vars() if v.persistable):
        got = tp._scope.find_var(n).get_tensor().numpy()
        want = np.asarray(jp._scope.find_var(n).get_tensor().numpy())
        np.testing.assert_array_equal(got, want, err_msg=n)
    rng = np.random.RandomState(1)
    for rows in (1, 3):
        x = rng.randn(rows, 3, IMG, IMG).astype(np.float32)
        name = jp.get_input_names()[0]
        want, = jp._run_feed({name: x}).values()
        got, = tp.run_feed({name: x}).values()
        assert got.shape == (rows, CLASSES)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=PRED_ATOL)


def test_ir_optim_off_serves_the_program_as_loaded(tmp_path):
    """``switch_ir_optim(False)`` keeps the loaded program (its batch
    norms, no fused ops), and its logits equal the rewritten program's:
    the passes keep the function."""
    dirname = _save_jax("resnet18", str(tmp_path / "r18"))
    cfg = AnalysisConfig(dirname)
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)
    plain = AnalysisPredictor(cfg)
    _jp, fused = _predictors(dirname)
    types = {op.type for op in plain.program().global_block().ops}
    assert "batch_norm" in types and "fc" not in types
    x = {"img": np.random.RandomState(2).randn(2, 3, IMG, IMG)
         .astype(np.float32)}
    want, = fused.run_feed(x).values()
    got, = plain.run_feed(x).values()
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_ATOL)


def test_bert_tiny_encoder_passes_match_reference(tmp_path):
    """The BERT_TINY encoder's inference program after both predictors'
    pass pipelines: the same ops (the embeddings' is_test dropout became
    assign; no reference pass the port lacks would rewrite it)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        inputs, seq_out = jbert.bert_encoder(jbert.BERT_TINY, 16,
                                             is_test=True)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.save_inference_model(str(tmp_path), [v.name for v in inputs],
                                   [seq_out], exe, main_program=main)
    jp, tp = _predictors(str(tmp_path))
    assert _op_dicts(tp.program()) == _op_dicts(jp.program())


def test_unported_pass_raises_where_it_would_rewrite():
    """A chain of two relu fc ops (which the reference's
    repeated_fc_relu_fuse_pass would fuse) stops the port's pipeline."""
    main, startup = tfw.Program(), tfw.Program()
    with tfw.program_guard(main, startup):
        x = tlayers.data("x", shape=[6])
        y = tlayers.fc(tlayers.fc(x, 5, act="relu"), 4, act="relu")
    tir.apply_pass("fc_fuse_pass", main, None, protected={"x", y.name})
    with pytest.raises(NotImplementedError, match="repeated_fc_relu"):
        tir.apply_pass("repeated_fc_relu_fuse_pass", main, None,
                       protected={"x", y.name})


# -- training 

def _train(model, steps, batch, lr):
    """``steps`` steps of both packages from the reference's initial state
    on one batch -> (JAX losses, port losses, JAX velocities, port
    velocities)."""
    (jm, js, (_i, _o, jloss)), (tm, _ts, (_ti, _to, tloss)) = \
        _programs(model, lr=lr)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(batch, 3, IMG, IMG).astype(np.float32),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in jm.list_vars()
             if v.persistable and not v.is_data]
    with fluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}
        jl = [float(np.asarray(exe.run(jm, feed=feed,
                                       fetch_list=[jloss])[0]).ravel()[0])
              for _ in range(steps)]
        jv = {n: np.array(scope.find_var(n).get_tensor().numpy())
              for n in names if "velocity" in n}
    tsc = scope_from_numpy(Scope(), init, "cpu", program=tm)
    texe = Executor(tfw.CPUPlace())
    tl = [float(texe.run(tm, feed=feed, fetch_list=[tloss],
                         scope=tsc)[0].ravel()[0]) for _ in range(steps)]
    assert any(op.type == "fused_momentum" for op in tm.global_block().ops)
    tv = {n: tsc.find_var(n).get_tensor().numpy() for n in jv}
    return jl, tl, jv, tv


def test_resnet18_trains_with_the_reference_losses():
    jl, tl, _jv, _tv = _train("resnet18", STEPS, BATCH, LR)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert tl[-1] < tl[0]


def test_resnet18_first_step_at_the_bundled_lr():
    jl, tl, jv, tv = _train("resnet18", 1, 4, 0.1)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    for n, w in jv.items():
        np.testing.assert_allclose(tv[n], w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=n)


def test_trunk_trains_with_the_reference_losses(kernel_route):
    jl, tl, _jv, _tv = _train("trunk", STEPS, BATCH, LR)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert tl[-1] < tl[0]
    assert "conv_block" in adoption.active_kernels()
