"""Training through the PyTorch port's Program front end
(``build_pretrain`` -> ``Adam.minimize`` -> ``Executor.run``) held
against the JAX package's on the CPU, from the same weights.

* BERT_TINY widths at dropout 0 (the slice's cut): the JAX package runs
  its startup, and its scope's parameters and Adam state (moments, beta
  pows, ``learning_rate_0``) are carried into the port, through
  ``scope_from_numpy(..., program=)`` and through the reference's
  ``save_persistables`` directory read by the port's
  ``load_persistables``.  Both take 5 Adam steps (lr 1e-3) on one batch
  with padded rows and repeated mask positions: the losses agree to 1e-4
  (f32 in another summation order; measured 2e-5), and every final
  parameter to 2 * lr * steps: where a gradient is near zero, Adam's
  update m / (sqrt(v) + eps) is near +-lr whatever its size, so a
  rounding difference can flip its sign and move that parameter by up to
  2 lr a step.  That bound only rules out runaway parameters; the Adam
  moments, which follow the gradients smoothly, hold the gradients:
  each moment tensor agrees to 5e-3 of its largest element (measured
  6.3e-4), with a floor of 1e-4 of the largest first moment (1e-8 of the
  largest second moment) for the key projections' biases, whose
  gradient is zero but for rounding (softmax ignores a shift shared by a
  row's scores).
* The MNIST MLP of ``models.bundled_builders()`` trains 20 Adam steps
  with the reference's losses (to 1e-5) from the same initial
  parameters."""

import tempfile

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import models as jmodels
from paddle_tpu.models import bert as jbert
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import (Executor, Scope, scope_from_numpy,
                                   scope_guard, scope_to_numpy)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.utils import unique_name as tun

SEQ = 16
BATCH = 4
LR = 1e-3
STEPS = 5
LOSS_ATOL = 1e-4
MOMENT_RTOL = 5e-3
MOMENT_FLOOR = 1e-4


def tiny(mod):
    return mod.BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                          ffn=128, max_pos=64, dropout=0.0)


def feed(seed=0):
    """bench.py's _bert_feed plus padded tails, so the attention bias
    masks keys; mask positions repeat, so gather's grad accumulates."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(4, SEQ + 1, BATCH)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.float32)
    n_mask = int(BATCH * SEQ * 0.15)
    pos = rng.randint(0, BATCH * SEQ, n_mask)
    pos[1] = pos[0]
    return {"src_ids": rng.randint(0, 1024, (BATCH, SEQ, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(SEQ).reshape(1, SEQ, 1),
                               (BATCH, 1, 1)).astype(np.int64),
            "sent_ids": rng.randint(0, 2, (BATCH, SEQ, 1)).astype(np.int64),
            "input_mask": mask[:, :, None],
            "mask_pos": pos.astype(np.int64),
            "mask_label": rng.randint(0, 1024, (n_mask, 1)).astype(np.int64)}


def jax_run(build, feeds, save_to=None):
    """Startup, optional save of the persistables, steps; returns (initial
    persistables, losses, final persistables)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with jun.guard(), fluid.program_guard(main, startup):
        loss = build()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = [v.name for v in main.list_vars()
             if v.persistable and not v.is_data]

    def state():
        return {n: np.array(scope.find_var(n).get_tensor().numpy())
                for n in names}

    with fluid.scope_guard(scope):
        exe.run(startup)
        init = state()
        if save_to is not None:
            fluid.io.save_persistables(exe, save_to, main)
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]).ravel()[0])
                  for f in feeds]
    return init, losses, state()


def port_program(build):
    main, startup = tfw.Program(), tfw.Program()
    with tun.guard(), tfw.program_guard(main, startup):
        loss = build()
    return main, loss


def port_steps(main, loss, scope, feeds):
    exe = Executor(tfw.CPUPlace())
    return [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0].ravel()[0]) for f in feeds]


def jax_bert():
    return jbert.build_pretrain(tiny(jbert), seq_len=SEQ, lr=LR)[1]


def port_bert():
    return tbert.build_pretrain(tiny(tbert), seq_len=SEQ, lr=LR)[1]


@pytest.mark.parametrize("carry", ["scope_from_numpy", "persistables dir"])
def test_bert_tiny_trains_as_the_reference(carry):
    feeds = [feed()] * STEPS
    with tempfile.TemporaryDirectory() as d:
        init, want, want_state = jax_run(jax_bert, feeds, save_to=d)
        main, loss = port_program(port_bert)
        if carry == "scope_from_numpy":
            scope = scope_from_numpy(Scope(), init, "cpu", program=main)
        else:
            scope = Scope()
            with scope_guard(scope):
                n = tio.load_persistables(Executor(tfw.CPUPlace()), d, main)
            assert n == len(init)
    # the Adam state came across: moments, beta pows, learning rate
    got_init = scope_to_numpy(scope, main)
    assert sorted(got_init) == sorted(init)
    assert any("moment1" in n for n in got_init) \
        and "learning_rate_0" in got_init
    for n, a in init.items():
        np.testing.assert_array_equal(got_init[n], a)
    got = port_steps(main, loss, scope, feeds)
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert got[-1] < got[0]
    assert sum(op.type == "fused_adam" for op in main.global_block().ops) == 1
    final = scope_to_numpy(scope, main)
    bound = 2 * LR * STEPS
    for n, w in want_state.items():
        np.testing.assert_allclose(final[n], w, atol=bound, rtol=0,
                                   err_msg=n)
    moments = [n for n in want_state if "_moment" in n]
    assert len(moments) == 2 * sum(
        isinstance(v, tfw.Parameter) for v in main.list_vars())
    top = {k: max(np.abs(want_state[n]).max() for n in moments if k in n)
           for k in ("_moment1_", "_moment2_")}
    floor = {"_moment1_": MOMENT_FLOOR * top["_moment1_"],
             "_moment2_": MOMENT_FLOOR ** 2 * top["_moment2_"]}
    for n in moments:
        w = want_state[n]
        kind = "_moment1_" if "_moment1_" in n else "_moment2_"
        scale = max(np.abs(w).max(), floor[kind])
        np.testing.assert_allclose(final[n], w, atol=MOMENT_RTOL * scale,
                                   rtol=0, err_msg=n)


def test_scope_from_numpy_wants_every_persistable():
    main, _loss = port_program(port_bert)
    arrays = {v.name: np.zeros(v.shape, np.float32) for v in main.list_vars()
              if v.persistable and not v.is_data}
    arrays.pop("word_emb")
    with pytest.raises(KeyError, match="word_emb"):
        scope_from_numpy(Scope(), arrays, "cpu", program=main)


def test_mnist_mlp_trains_as_the_reference():
    rng = np.random.RandomState(0)
    centres = rng.randn(10, 784).astype(np.float32)
    feeds = []
    for _ in range(20):
        label = rng.randint(0, 10, (32, 1)).astype(np.int64)
        img = (centres[label.ravel()]
               + rng.randn(32, 784)).astype(np.float32)
        feeds.append({"img": img, "label": label})

    def jax_mlp():
        _feeds, (loss, _acc) = jmodels.bundled_builders()["mnist_mlp"]()
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return loss

    def port_mlp():
        loss = tmnist.build_mlp()[3]
        topt.Adam(learning_rate=1e-2).minimize(loss)
        return loss

    init, want, _state = jax_run(jax_mlp, feeds)
    main, loss = port_program(port_mlp)
    scope = scope_from_numpy(Scope(), init, "cpu", program=main)
    got = port_steps(main, loss, scope, feeds)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < 0.1 * got[0]
