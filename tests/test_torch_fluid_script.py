"""Fluid scripts run unchanged on the port: ``fluid`` bound to the JAX
package, then to ``paddle_tpu_torch``.

* BASELINE config 1, the MNIST MLP (two ``layers.fc`` of 200 and a
  softmax head, Adam), as one script text: ``fluid.batch`` over
  ``fluid.datasets.mnist``, ``DataFeeder`` feeds, a ``clone(for_test=
  True)`` evaluation accumulated by ``fluid.metrics.Accuracy``.  From the
  reference's initial weights, the port's 20 losses equal the
  reference's to LOSS_ATOL, and both reach test accuracy above
  MIN_ACCURACY.  The same through ``CompiledProgram(...)
  .with_data_parallel`` and a non-iterable ``fluid.io.PyReader`` to
  ``fluid.core.EOFException``, and through an iterable
  ``DataLoader.from_generator``.
* ``nets`` (re-posing ``tests/test_nets.py``): each block builds the
  reference's program and, from one feed and the reference's weights,
  gives its outputs to NETS_RTOL; ``sequence_conv_pool`` raises by name.
* ``metrics``, ``average``, ``input``, ``lod_tensor`` and ``evaluator``
  (re-posing ``tests/test_fluid_compat_modules.py``).
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import scope_from_numpy

LOSS_ATOL = 1e-5
MIN_ACCURACY = 0.97
NETS_RTOL = 1e-5
STEPS = 20

PREAMBLE = '''
main, startup = fluid.Program(), fluid.Program()
startup.random_seed = 1
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    hidden = fluid.layers.fc(input=img, size=200, act="relu")
    hidden = fluid.layers.fc(input=hidden, size=200, act="relu")
    logits = fluid.layers.fc(input=hidden, size=10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                label=label)
    test_program = main.clone(for_test=True)
    fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
'''

EVALUATE = '''
test_acc = fluid.metrics.Accuracy()
for data in fluid.batch(fluid.datasets.mnist.test(), 128)():
    a, = exe.run(test_program, feed=feeder.feed(data), fetch_list=[acc])
    test_acc.update(value=a, weight=len(data))
'''

SCRIPTS = {
    "feeder": PREAMBLE + '''
place = fluid.CPUPlace()
exe = fluid.Executor(place)
feeder = fluid.DataFeeder(feed_list=[img, label], place=place)
exe.run(startup)
share(main)
losses = []
for data in fluid.batch(fluid.datasets.mnist.train(), batch_size=128)():
    lo, = exe.run(main, feed=feeder.feed(data), fetch_list=[loss])
    losses.append(float(lo[0]))
    if len(losses) == STEPS:
        break
''' + EVALUATE,
    "compiled_pyreader": PREAMBLE + '''
place = fluid.CPUPlace()
exe = fluid.Executor(place)
feeder = fluid.DataFeeder(feed_list=[img, label], place=place)
with fluid.program_guard(main, startup):
    reader = fluid.io.PyReader(feed_list=[img, label], capacity=8,
                               iterable=False)
train = fluid.batch(fluid.datasets.mnist.train(), 128)
reader.decorate_sample_list_generator(fluid.reader.firstn(train, STEPS))
compiled = fluid.CompiledProgram(main).with_data_parallel(
    loss_name=loss.name)
exe.run(startup)
share(main)
losses = []
reader.start()
try:
    while True:
        lo, = exe.run(compiled, fetch_list=[loss.name])
        losses.append(float(lo[0]))
except fluid.core.EOFException:
    reader.reset()
''' + EVALUATE,
    "dataloader": PREAMBLE + '''
place = fluid.CPUPlace()
exe = fluid.Executor(place)
feeder = fluid.DataFeeder(feed_list=[img, label], place=place)
loader = fluid.io.DataLoader.from_generator(feed_list=[img, label],
                                            capacity=4)
train = fluid.batch(fluid.datasets.mnist.train(), 128)
loader.set_sample_list_generator(fluid.reader.firstn(train, STEPS),
                                 places=fluid.cpu_places())
exe.run(startup)
share(main)
losses = []
for data in loader:
    lo, = exe.run(main, feed=data, fetch_list=[loss])
    losses.append(float(lo[0]))
''' + EVALUATE,
}


def _run_script(pkg, text, init):
    """Run ``text`` with ``fluid`` bound to ``pkg``; ``share`` records the
    persistables after the startup program into ``init`` (empty), or sets
    them from it.  -> (losses, test accuracy)."""

    def share(main):
        scope = pkg.global_scope()
        names = [v.name for v in main.list_vars()
                 if v.persistable and not v.is_data]
        if not init:
            init.update({n: np.asarray(scope.find_var(n).get_tensor()
                                       .numpy()) for n in names})
        else:
            scope_from_numpy(scope, init, "cpu", program=main)

    env = {"fluid": pkg, "share": share, "STEPS": STEPS}
    with pkg.scope_guard(pkg.Scope()):
        exec(compile(text, "<script>", "exec"), env)
    return env["losses"], env["test_acc"].eval()


@pytest.fixture(scope="module")
def reference_runs():
    out = {}
    for name, text in SCRIPTS.items():
        init = {}
        out[name] = _run_script(fluid, text, init) + (init,)
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_baseline_config_1_script_matches_the_reference(script,
                                                        reference_runs):
    want, want_acc, init = reference_runs[script]
    got, got_acc = _run_script(tfluid, SCRIPTS[script], dict(init))
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    assert got_acc > MIN_ACCURACY and want_acc > MIN_ACCURACY
    assert abs(got_acc - want_acc) < 1e-6


# -- nets ---------------------------------------------------------------------

B, T, D = 2, 5, 8


def _nets_case(pkg, case):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 4
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        if case == "simple_img_conv_pool":
            img = pkg.layers.data("img", shape=[1, 8, 8])
            out = pkg.nets.simple_img_conv_pool(
                img, num_filters=4, filter_size=3, pool_size=2,
                pool_stride=2, conv_padding=1, act="relu")
        elif case == "img_conv_group":
            img = pkg.layers.data("img", shape=[3, 8, 8])
            out = pkg.nets.img_conv_group(
                img, conv_num_filter=[4, 4], pool_size=2, conv_act="relu",
                conv_with_batchnorm=True, conv_batchnorm_drop_rate=0.0,
                pool_stride=2)
        elif case == "glu":
            v = pkg.layers.data("v", shape=[8])
            out = pkg.nets.glu(v, dim=-1)
        else:
            heads = int(case[-1])
            q, k, v = (pkg.layers.data(n, shape=[B, T, D],
                                       append_batch_size=False)
                       for n in "qkv")
            out = pkg.nets.scaled_dot_product_attention(q, k, v,
                                                        num_heads=heads)
    return main, startup, out


def _nets_feed(case):
    rng = np.random.RandomState(1)
    if case == "simple_img_conv_pool":
        return {"img": rng.rand(2, 1, 8, 8).astype("f")}
    if case == "img_conv_group":
        return {"img": rng.rand(2, 3, 8, 8).astype("f")}
    if case == "glu":
        return {"v": rng.rand(4, 8).astype("f")}
    return {n: rng.rand(B, T, D).astype("f") for n in "qkv"}


@pytest.mark.parametrize("case", ["simple_img_conv_pool", "img_conv_group",
                                  "glu", "attention_1", "attention_2"])
def test_nets_match_the_reference(case):
    feed = _nets_feed(case)
    jm, js, jo = _nets_case(fluid, case)
    tm, ts, to = _nets_case(tfluid, case)
    assert tm.to_dict() == jm.to_dict()
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        jexe.run(js)
        init = {v.name: np.asarray(fluid.global_scope().find_var(v.name)
                                   .get_tensor().numpy())
                for v in jm.list_vars() if v.persistable}
        want, = jexe.run(jm, feed=feed, fetch_list=[jo])
    sc = scope_from_numpy(tfluid.Scope(), init, "cpu", program=tm)
    got, = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                                  fetch_list=[to], scope=sc)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=NETS_RTOL,
                               atol=NETS_RTOL * np.abs(want).max())


def test_sequence_conv_pool_raises_by_name():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        seq = tfluid.layers.data("seq", shape=[6, 8])
        with pytest.raises(NotImplementedError, match="A9"):
            tfluid.nets.sequence_conv_pool(seq, 5, 3)


# -- metrics, average, input, lod_tensor, evaluator ---------------------------


def _metric_updates(m):
    rng = np.random.RandomState(3)
    preds = rng.rand(40, 2).astype("f")
    labels = rng.randint(0, 2, (40, 1))
    return {
        "Accuracy": [((0.5,), {"weight": 4}), ((0.75,), {"weight": 12})],
        "Precision": [((preds[:, 1:],), {"labels": labels})],
        "Recall": [((preds[:, 1:],), {"labels": labels})],
        "Auc": [((preds,), {"labels": labels})],
        "ChunkEvaluator": [((10, 12, 7), {}), ((4, 3, 3), {})],
        "EditDistance": [((np.array([0.0, 2.0, 1.0]),), {"seq_num": 3})],
        "DetectionMAP": [((0.4,), {"weight": 2}), ((0.7,), {})],
    }[m]


@pytest.mark.parametrize("metric", ["Accuracy", "Precision", "Recall", "Auc",
                                    "ChunkEvaluator", "EditDistance",
                                    "DetectionMAP"])
def test_metrics_match_the_reference(metric):
    ref, port = getattr(fluid.metrics, metric)(), \
        getattr(tfluid.metrics, metric)()
    for args, kwargs in _metric_updates(metric):
        ref.update(*args, **kwargs)
        port.update(*args, **kwargs)
    np.testing.assert_array_equal(np.asarray(port.eval()),
                                  np.asarray(ref.eval()))
    comp = tfluid.metrics.CompositeMetric()
    comp.add_metric(tfluid.metrics.Precision())
    comp.add_metric(tfluid.metrics.Recall())
    comp.update(np.array([1, 0, 1]), np.array([1, 1, 0]))
    assert comp.eval() == [0.5, 0.5]


def test_weighted_average_lod_tensor_and_input():
    w = tfluid.average.WeightedAverage()
    w.add(2.0, 1)
    w.add(np.array([4.0, 6.0]), 3)
    np.testing.assert_allclose(w.eval(), [3.5, 5.0])
    w.reset()
    with pytest.raises(ValueError):
        w.eval()
    t = tfluid.create_lod_tensor([[1, 2, 3], [4, 5]], [[3, 2]],
                                 tfluid.CPUPlace())
    j = fluid.create_lod_tensor([[1, 2, 3], [4, 5]], [[3, 2]],
                                fluid.CPUPlace())
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert t.lod() == j.lod() == [[0, 3, 5]]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    with pytest.raises(ValueError):
        tfluid.create_lod_tensor(np.zeros((4, 2), "f"), [[3, 2]], None)
    r = tfluid.create_random_int_lodtensor([[2, 3]], [1], None, 0, 9)
    assert r.shape() == [5, 1] and 0 <= r.numpy().min() <= 9
    nested = tfluid.create_lod_tensor(t, [[1, 1], [3, 2]], None)
    assert nested.lod() == [[0, 1, 2], [0, 3, 5]]


def test_v2_one_hot_and_embedding_match_the_reference():
    iv = np.array([0, 2, 5, 2], "int64")
    outs = {}
    for name, pkg in (("ref", fluid), ("port", tfluid)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            ids = pkg.layers.data("ids", shape=[4], dtype="int64",
                                  append_batch_size=False)
            oh = pkg.one_hot(ids, depth=6)
            emb = pkg.embedding(ids, size=[6, 3], padding_idx=2)
        outs[name] = (main, startup, oh, emb)
    jm, js, joh, jemb = outs["ref"]
    tm, ts, toh, temb = outs["port"]
    assert tm.to_dict() == jm.to_dict()
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        jexe.run(js)
        w = np.asarray(fluid.global_scope().find_var("embedding_0.w_0")
                       .get_tensor().numpy())
        want = jexe.run(jm, feed={"ids": iv}, fetch_list=[joh, jemb])
    sc = scope_from_numpy(tfluid.Scope(), {"embedding_0.w_0": w}, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed={"ids": iv}, fetch_list=[toh, temb], scope=sc)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(x))
    assert got[1][1].tolist() == [0.0, 0.0, 0.0]  # the padding id


@pytest.mark.parametrize("name", ["ChunkEvaluator", "EditDistance",
                                  "DetectionMAP"])
def test_evaluators_raise_by_name(name):
    with pytest.raises(NotImplementedError, match="A9"):
        getattr(tfluid.evaluator, name)(None, None)
