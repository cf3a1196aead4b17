"""Two faults of the port against the reference, pinned repaired.

* ``top_k`` breaks ties as ``lax.top_k`` does, the lower index first: on
  tied rows and on [1, 3, 3, 2, 3, 0, 1], the port's lowering gives the
  reference's values and indices exactly; so do ``layers.topk`` and
  ``layers.accuracy`` (which reads the top-k indices) run as programs in
  both packages from one feed.
* ``split`` with a negative section raises ValueError, as the
  reference's ``jnp.split`` does, in the lowering and through the layer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TCtx

TIE_CASES = {
    "zeros": (np.zeros((2, 6), np.float32), 3),
    "roadmap": (np.array([[1, 3, 3, 2, 3, 0, 1]], np.float32), 3),
    "rows_of_ties": (np.array([[2, 2, 1, 2], [0, 5, 5, 5]], np.float32), 2),
    "3d": (np.random.RandomState(0).randint(0, 3, (2, 3, 5))
           .astype(np.float32), 4),
    "negative_zero": (np.array([[0.0, -0.0, -1.0, 0.0]], np.float32), 3),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_top_k_ties_match_the_reference(case):
    x, k = TIE_CASES[case]
    want_v, want_i = jreg.get_op_def("top_k").lower(
        JCtx(mode="eager"), jnp.asarray(x), None, k=k)
    got_v, got_i = treg.get_op_def("top_k").lower(
        TCtx(torch.device("cpu")), torch.from_numpy(x), None, k=k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.dtype == torch.int64


def test_top_k_reads_the_k_input():
    x = np.array([[1, 3, 3, 2, 3, 0, 1]], np.float32)
    _v, idx = treg.get_op_def("top_k").lower(
        TCtx(torch.device("cpu")), torch.from_numpy(x),
        torch.tensor([2], dtype=torch.int32), k=5)
    assert idx.tolist() == [[1, 2]]


def _topk_accuracy(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[6])
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        _vals, idx = pkg.layers.topk(x, k=3)
        acc1 = pkg.layers.accuracy(x, label, k=1)
        acc3 = pkg.layers.accuracy(x, label, k=3)
    return main, [idx, acc1, acc3]


@pytest.mark.parametrize("label", [0, 3, 5])
def test_topk_and_accuracy_layers_on_ties(label):
    """A zero head ties every logit: the top-1 is class 0 and the top-3
    classes 0-2 in both packages."""
    feed = {"x": np.zeros((4, 6), np.float32),
            "label": np.full((4, 1), label, np.int64)}
    jm, jf = _topk_accuracy(fluid)
    want = fluid.Executor(fluid.CPUPlace()).run(jm, feed=feed, fetch_list=jf)
    tm, tf = _topk_accuracy(tfluid)
    got = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                                 fetch_list=tf)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[0], np.tile([0, 1, 2], (4, 1)))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert float(got[1][0]) == float(label == 0)
    assert float(got[2][0]) == float(label < 3)


def test_split_negative_section_raises_like_the_reference():
    x = np.arange(18, dtype=np.float32).reshape(6, 3)
    with pytest.raises(ValueError):
        jreg.get_op_def("split").lower(JCtx(mode="eager"), jnp.asarray(x),
                                       None, [], axis=0,
                                       sections=[2, -1, 1])
    with pytest.raises(ValueError, match="nonnegative"):
        treg.get_op_def("split").lower(TCtx(torch.device("cpu")),
                                       torch.from_numpy(x), None, [],
                                       axis=0, sections=[2, -1, 1])
    pieces = treg.get_op_def("split").lower(
        TCtx(torch.device("cpu")), torch.from_numpy(x), None, [], axis=0,
        sections=[2, 3, 1])
    assert [p.shape[0] for p in pieces] == [2, 3, 1]


def test_split_layer_with_a_negative_section_raises_at_run():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[6], append_batch_size=False)
        parts = tfluid.layers.split(x, [2, -1, 1], dim=0)
    with pytest.raises(ValueError, match="nonnegative"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed={"x": np.zeros(6, np.float32)}, fetch_list=parts)
