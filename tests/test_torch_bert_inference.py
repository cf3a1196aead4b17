"""BERT_TINY inference through the PyTorch port's predictor
(paddle_tpu_torch/inference.py, io.py, core/executor.py, ops/) held
against the JAX package's on the CPU, both directions of the saved
directory bridge:

* a directory the JAX package saves (``__model__.json`` +
  ``__params__.npz``) runs in the port's ``AnalysisPredictor`` on the CPU
  with the JAX ``AnalysisPredictor``'s outputs, atol 1e-5 (f32, another
  library's summation order);
* a directory the port saves (its own program, its own startup draws)
  runs in the JAX predictor with the port's outputs, atol 1e-5.

Every input masks a different tail of each row, so the attention bias
carries real padding.  The 1e-5 holds at every real (unmasked) token.  A
masked token's query sees every key at a bias of -1e4, where f32 values
are spaced ~1e-3 apart: a 1e-7 difference in q.k (summation order)
flips a rounding there, so those rows, which no caller reads, are held
to 1e-3 (measured up to 1.7e-4 over 20 seeds)."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import AnalysisPredictor as JPredictor
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.core import scope_guard
from paddle_tpu_torch.inference import (AnalysisConfig, AnalysisPredictor,
                                        PaddleTensor)
from paddle_tpu_torch.models import bert as tbert

SEQ = 16
ATOL = 1e-5
ATOL_MASKED = 1e-3


def assert_bert_close(got, want, mask):
    """``got`` equals ``want`` [rows, SEQ, hidden] to ATOL at the tokens
    ``mask`` [rows, SEQ, 1] keeps and to ATOL_MASKED at the others."""
    assert got.shape == want.shape
    keep = mask[:, :, 0] > 0
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[~keep], want[~keep], atol=ATOL_MASKED,
                               rtol=0)


def bert_feeds(rng, rows, lens=None):
    """Random ids; input_mask keeps ``lens[i]`` leading tokens of row i."""
    cfg = jbert.BERT_TINY
    lens = rng.randint(2, SEQ + 1, rows) if lens is None \
        else np.asarray(lens)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.float32)
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (rows, SEQ, 1))
        .astype(np.int64),
        "pos_ids": np.tile(np.arange(SEQ).reshape(1, SEQ, 1),
                           (rows, 1, 1)).astype(np.int64),
        "sent_ids": rng.randint(0, cfg.type_vocab, (rows, SEQ, 1))
        .astype(np.int64),
        "input_mask": mask[:, :, None],
    }


def save_jax_bert_tiny(dirname):
    """The JAX package builds BERT_TINY, runs its startup on the CPU and
    saves an inference directory."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        inputs, seq_out = jbert.bert_encoder(jbert.BERT_TINY, SEQ,
                                             is_test=True)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.save_inference_model(dirname, [v.name for v in inputs],
                                   [seq_out], exe, main_program=main)
    return dirname


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return save_jax_bert_tiny(str(tmp_path_factory.mktemp("jbert")))


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """The port builds BERT_TINY, runs its startup on the CPU (torch
    generator draws) and saves."""
    dirname = str(tmp_path_factory.mktemp("tbert"))
    main, startup = tfw.Program(), tfw.Program()
    startup.random_seed = 11
    with tfw.program_guard(main, startup):
        inputs, seq_out = tbert.bert_encoder(tbert.BERT_TINY, SEQ,
                                             is_test=True)
    exe = Executor(tfw.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        tio.save_inference_model(dirname, [v.name for v in inputs],
                                 [seq_out], exe, main_program=main)
    return dirname


def _jax_predictor(dirname):
    cfg = JConfig(dirname)
    cfg.disable_gpu()
    return JPredictor(cfg)


def _port_predictor(dirname):
    cfg = AnalysisConfig(dirname)
    cfg.disable_gpu()
    return AnalysisPredictor(cfg)


def _only(outs):
    (name, arr), = outs.items()
    return name, arr


@pytest.mark.parametrize("rows", [1, 3])
def test_port_predictor_runs_jax_saved_dir(jax_dir, rows):
    feeds = bert_feeds(np.random.RandomState(rows), rows)
    wname, want = _only(_jax_predictor(jax_dir)._run_feed(feeds))
    pred = _port_predictor(jax_dir)
    gname, got = _only(pred.run_feed(feeds))
    assert gname == wname and got.shape == (rows, SEQ, 64)
    assert_bert_close(got, want, feeds["input_mask"])
    assert str(pred.device) == "cpu"


def test_jax_predictor_runs_port_saved_dir(port_dir):
    feeds = bert_feeds(np.random.RandomState(7), 4, lens=[16, 1, 9, 5])
    wname, want = _only(_port_predictor(port_dir).run_feed(feeds))
    gname, got = _only(_jax_predictor(port_dir)._run_feed(feeds))
    assert gname == wname
    assert_bert_close(got, want, feeds["input_mask"])


def test_paddle_tensor_and_zero_copy_apis_and_clone(jax_dir):
    pred = _port_predictor(jax_dir)
    feeds = bert_feeds(np.random.RandomState(2), 2)
    want = _jax_predictor(jax_dir)._run_feed(feeds)
    name = pred.get_output_names()[0]
    outs = pred.run([PaddleTensor(feeds[n], name=n)
                     for n in pred.get_input_names()])
    assert_bert_close(outs[0].data, want[name], feeds["input_mask"])

    clone = pred.clone()
    assert clone._scope is pred._scope and clone._exe is pred._exe
    for n in clone.get_input_names():
        clone.get_input_tensor(n).copy_from_cpu(feeds[n])
    clone.zero_copy_run()
    assert_bert_close(clone.get_output_tensor(name).copy_to_cpu(),
                      want[name], feeds["input_mask"])
    with pytest.raises(RuntimeError, match="not staged"):
        pred.zero_copy_run()


def test_parameters_handed_over_as_numpy(jax_dir):
    """``scope_from_numpy`` + the port's Executor over the loaded
    program: the same outputs without the predictor."""
    program, feed_names, fetch_vars = tio.load_inference_model(
        jax_dir, Executor(tfw.CPUPlace()))
    with np.load(jax_dir + "/__params__.npz") as data:
        params = {k: data[k] for k in data.files}
    scope = scope_from_numpy(Scope(), params, "cpu")
    feeds = bert_feeds(np.random.RandomState(4), 2)
    got, = Executor(tfw.CPUPlace()).run(program, feed=feeds,
                                        fetch_list=fetch_vars, scope=scope)
    _, want = _only(_jax_predictor(jax_dir)._run_feed(feeds))
    assert_bert_close(got, want, feeds["input_mask"])
    assert set(feed_names) == set(feeds)


def test_entry_points_default_to_the_card(jax_dir):
    """Without a card the defaults raise: the CPU only runs when asked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA device"):
        AnalysisPredictor(AnalysisConfig(jax_dir))
