"""The port's static verifier (``core/analysis.py``) held against the
reference's on the CPU (re-posing the single-program cases of
``tests/test_program_verifier.py``).

* Planted faults: a dangling input (WF001), an unregistered op type
  (WF002), an undeclared slot (WF005), a dead op (WF004), a declared dtype
  (TS001) and shape (TS002) the op contradicts, a grad var of another
  shape than its forward var (TS003): the port's report has the
  reference's rules, severities, block and op indices, and the verifier
  changes nothing in the program it checks.
* The port's counterparts of the reference's bundled programs (the
  MNIST MLP, ResNet-18, BERT_TINY at dropout 0 and 0.1, the tiny
  Transformer) give no error and no warning, their startup programs too
  (the tiny PTB LM: only the WF004 of the two state reshapes its basic
  emissions leave unread); and run through the Executor in ``error`` mode (the
  optimizer ops fused) they run.  An LSTM program (``layers.lstm``) gets
  the reference's WF001 findings, rule for rule.
* The modes: ``off`` never calls the verifier; ``warn`` warns once,
  counts ``static_check_warnings`` and runs it only on a plan miss (a
  steady step and a second executor's miss of the same program reuse the
  memo); ``error`` raises a readable ProgramVerificationError before any
  op runs, and a clean program still runs.
"""

import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import analysis as janalysis
from paddle_tpu_torch.core import analysis as tanalysis
from paddle_tpu_torch.core import telemetry as ttelemetry
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import ptb_lm as tptb
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer

PKGS = {"ref": (fluid, janalysis), "port": (tfluid, tanalysis)}


@pytest.fixture
def flags_restored():
    before = tfluid.get_flags(["FLAGS_static_check", "FLAGS_telemetry"])
    yield
    tfluid.set_flags(before)
    ttelemetry.reset()


def _wf001(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.relu(x)
        blk = main.global_block()
        ghost = blk.create_var(name="ghost", shape=[-1, 4], dtype="float32")
        blk.append_op(type="relu", inputs={"X": [ghost]},
                      outputs={"Out": [y]})
    return main, ["x"], [y.name]


def _wf002(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.relu(x)
        pkg.layers.scale(y, scale=2.0)
    main.global_block().ops[0].type = "definitely_not_an_op"
    return main, ["x"], []


def _wf005(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.relu(x)
    main.global_block().ops[0].inputs["Bogus"] = [x.name]
    return main, ["x"], [y.name]


def _wf004(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        pkg.layers.scale(x, scale=3.0)  # never read or fetched
        y = pkg.layers.scale(x, scale=2.0)
    return main, ["x"], [y.name]


def _ts001(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.relu(x)
    y.dtype = "int32"
    return main, ["x"], [y.name]


def _ts002(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.relu(x)
    y.shape = (-1, 7)
    return main, ["x"], [y.name]


def _ts003(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.relu(x)
    main.global_block().create_var(name=y.name + "@GRAD", shape=[-1, 5],
                                   dtype="int64")
    return main, ["x"], [y.name]


PLANTED = {"WF001": _wf001, "WF002": _wf002, "WF005": _wf005,
           "WF004": _wf004, "TS001": _ts001, "TS002": _ts002,
           "TS003": _ts003}


def _findings(rep):
    return sorted((d.rule, d.severity, d.block_idx, d.op_idx)
                  for d in rep.diagnostics if d.severity != "info")


@pytest.mark.parametrize("rule", sorted(PLANTED))
def test_planted_fault_gets_the_reference_report(rule):
    reps = {}
    for name, (pkg, an) in PKGS.items():
        main, feeds, fetches = PLANTED[rule](pkg)
        before = main.to_dict()
        reps[name] = an.verify_program(main, feeds, fetches, label=rule)
        assert main.to_dict() == before  # the checked program is unchanged
    assert reps["port"].by_rule(rule), reps["port"].format()
    assert _findings(reps["port"]) == _findings(reps["ref"]), (
        reps["port"].format(), reps["ref"].format())
    assert rule in reps["port"].format()


def _lstm(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[5, 8], dtype="float32")
        h0 = pkg.layers.data("h0", shape=[1, 6], dtype="float32")
        c0 = pkg.layers.data("c0", shape=[1, 6], dtype="float32")
        out, _h, _c = pkg.layers.lstm(x, h0, c0, 5, 6, 1)
        loss = pkg.layers.mean(out)
    return main, ["x", "h0", "c0"], [loss.name]


def test_lstm_program_gets_the_reference_wf001():
    reps = {name: an.verify_program(*_lstm(pkg))
            for name, (pkg, an) in PKGS.items()}
    assert _findings(reps["port"]) == _findings(reps["ref"])


def _mnist():
    img, label, _logits, loss, acc = tmnist.build_mlp()
    tfluid.optimizer.SGD(0.1).minimize(loss)
    return [img, label], [loss, acc]


def _resnet18():
    img, label, loss, acc = tresnet.build_train(depth=18, class_dim=10,
                                                image_size=32)
    return [img, label], [loss, acc]


def _bert(dropout):
    def build():
        cfg = tbert.BertConfig(**dict(vars(tbert.BERT_TINY),
                                      dropout=dropout))
        inputs, loss = tbert.build_pretrain(cfg, seq_len=16, lr=1e-3)
        return list(inputs), [loss]
    return build


def _transformer():
    cfg = ttransformer.TransformerConfig(
        src_vocab=64, trg_vocab=64, d_model=32, heads=2, enc_layers=1,
        dec_layers=1, ffn=64, max_len=16)
    feeds, loss = ttransformer.build_train(cfg, src_len=8, trg_len=8)
    return list(feeds), [loss]


def _ptb(rnn_model):
    def build():
        loss, last_h, last_c = tptb.build_train(tptb.PTB_TINY, rnn_model)
        block = loss.block.program.global_block()
        return ([v for v in block.vars.values() if v.is_data],
                [v for v in (loss, last_h, last_c) if v is not None])
    return build


BUNDLED = {"mnist_mlp": _mnist, "resnet18": _resnet18,
           "bert_tiny": _bert(0.0), "bert_tiny_dropout": _bert(0.1),
           "transformer_tiny": _transformer}


@pytest.mark.parametrize("name", sorted(BUNDLED))
def test_bundled_program_is_clean(name):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        feeds, fetches = BUNDLED[name]()
    rep = tanalysis.verify_program(main, [v.name for v in feeds],
                                   [v.name for v in fetches], label=name)
    assert not rep.errors and not rep.warnings, rep.format()
    srep = tanalysis.verify_program(startup, label=name + "/startup")
    assert not srep.errors and not srep.warnings, srep.format()


@pytest.mark.parametrize("rnn_model", ["basic_lstm", "basic_gru"])
def test_ptb_lm_warns_only_of_its_unused_state_reshapes(rnn_model):
    """PaddleNLP's script reshapes the initial states for its cudnn
    emission; the basic emissions read the states as fed, so the two
    reshapes are dead code, which WF004 reports (and nothing else)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        feeds, fetches = _ptb(rnn_model)()
    rep = tanalysis.verify_program(main, [v.name for v in feeds],
                                   [v.name for v in fetches])
    assert _findings(rep) == [("WF004", "warning", 0, 0),
                              ("WF004", "warning", 0, 1)], rep.format()
    assert all(main.global_block().ops[d.op_idx].type == "reshape2"
               for d in rep.warnings)


def _feed_of(v, rng):
    shape = [2 if d == -1 else d for d in v.shape]
    if v.dtype.startswith("int"):
        return rng.randint(0, 4, shape).astype(v.dtype)
    return rng.rand(*shape).astype(v.dtype)


@pytest.mark.parametrize("name", ["mnist_mlp", "bert_tiny"])
def test_bundled_program_runs_fused_under_error_mode(name, flags_restored):
    """The executor fuses the optimizer ops, then verifies on the plan
    miss: the fused program passes in error mode."""
    tfluid.set_flags({"FLAGS_static_check": "error"})
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        feeds, fetches = BUNDLED[name]()
    if name == "bert_tiny":
        feed = tbert.pretrain_feed(np.random.RandomState(0),
                                   tbert.BERT_TINY, 2, 16)
    else:
        rng = np.random.RandomState(0)
        feed = {v.name: _feed_of(v, rng) for v in feeds}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        out = exe.run(main, feed=feed, fetch_list=fetches[:1])
    assert np.isfinite(out[0]).all()
    assert any(op.type.startswith("fused_") for op in main.global_block().ops)


def _dead_op_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        tfluid.layers.scale(x, scale=3.0)  # never read or fetched
        y = tfluid.layers.scale(x, scale=2.0)
    return main, startup, y


def test_off_never_calls_the_verifier(flags_restored, monkeypatch):
    tfluid.set_flags({"FLAGS_static_check": "off"})

    def boom(*a, **k):
        raise AssertionError("verifier ran with FLAGS_static_check=off")

    monkeypatch.setattr(tanalysis, "verify_program", boom)
    main, startup, y = _dead_op_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    out = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                  fetch_list=[y])[0]
    np.testing.assert_allclose(out, 2 * np.ones((2, 4)))


def test_warn_mode_warns_counts_and_runs_on_a_plan_miss_only(
        flags_restored, monkeypatch):
    tfluid.set_flags({"FLAGS_static_check": "warn", "FLAGS_telemetry": True})
    ttelemetry.reset()
    calls = []
    real = tanalysis.verify_program
    monkeypatch.setattr(tanalysis, "verify_program",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    main, startup, y = _dead_op_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.ones((2, 4), "float32")}
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        exe.run(main, feed=feed, fetch_list=[y])
    assert any(issubclass(w.category, tanalysis.ProgramVerifyWarning)
               and "WF004" in str(w.message) for w in got)
    assert len(calls) == 1 and tanalysis.checked_reports()[-1].ms > 0
    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        exe.run(main, feed=feed, fetch_list=[y])  # a plan hit
        tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed,
                                               fetch_list=[y])  # memo
    assert len(calls) == 1
    assert not any(issubclass(w.category, tanalysis.ProgramVerifyWarning)
                   for w in again)
    assert ttelemetry.counter_total("static_check_warnings") == 1
    exe.run(main, feed={"x": np.ones((3, 4), "float32")}, fetch_list=[y])
    assert len(calls) == 2  # a new feed shape is a plan miss


def test_error_mode_raises_before_any_op_runs(flags_restored, monkeypatch):
    tfluid.set_flags({"FLAGS_static_check": "error"})
    from paddle_tpu_torch.core import executor as texecutor

    ran = []
    real = texecutor.run_op
    monkeypatch.setattr(texecutor, "run_op",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    main, _feeds, _fetches = _wf001(tfluid)
    y = main.global_block().ops[-1].output("Out")[0]
    with pytest.raises(tanalysis.ProgramVerificationError) as ei:
        tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[y])
    assert "WF001" in str(ei.value) and "ghost" in str(ei.value)
    assert not ran
    main2, _startup, y2 = _dead_op_program()
    main2.global_block().ops.pop(0)  # the dead op: now clean
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        main2, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[y2])[0]
    np.testing.assert_allclose(out, 2 * np.ones((2, 4)))
