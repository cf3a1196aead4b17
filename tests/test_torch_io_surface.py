"""The port's single-card save and load and its package surface, held
against the JAX package on the CPU (re-posing
``tests/test_api_surface.py:37-162`` and ``:374``).

* ``fluid.save`` / ``fluid.load``: Adam's ``.pdopt`` written and read;
  three steps after a load equal three uninterrupted steps (RESUME_RTOL);
  no ``.pdopt`` for a forward-only program; an empty basename, a shape
  clash and a load before the startup program raise as the reference's
  do; ``load_program_state`` / ``set_program_state`` round trip and warn
  on keys the program lacks.
* Across the packages, in both directions: checkpoints of ``fluid.save``,
  ``save_persistables``, ``save_params`` + ``load_vars`` and
  ``save_train_model`` written by one package load into the other, and
  the next step's loss matches CROSS_ATOL.
* The surface: ``import paddle_tpu_torch as fluid`` has each name of the
  reference's surface this slice ports, ``fluid.data`` declares the
  reference's variable, and the names still to come raise AttributeError
  naming their ROADMAP item; ``CompiledProgram`` runs the inner program,
  and more than one place raises.
"""

import os
import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as tfluid

RESUME_RTOL = 1e-6
CROSS_ATOL = 1e-5
PKGS = {"ref": fluid, "port": tfluid}


def _small_net(pkg, opt_factory):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 9
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        y = pkg.layers.data("y", shape=[1])
        h = pkg.layers.fc(x, 8, act="relu")
        pred = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        opt_factory(pkg).minimize(loss)
    return main, startup, loss


def _adam(pkg):
    return pkg.optimizer.Adam(0.01)


def _sgd(pkg):
    return pkg.optimizer.SGD(0.1)


def _feeds(n=6):
    rng = np.random.RandomState(0)
    return [{"x": rng.randn(16, 4).astype("float32"),
             "y": rng.randn(16, 1).astype("float32")} for _ in range(n)]


def _run(exe, main, loss, feeds):
    return [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
            for f in feeds]


def test_save_load_roundtrip_adam(tmp_path):
    feeds = _feeds()
    path = os.path.join(str(tmp_path), "ckpt", "model")
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, startup, loss = _small_net(tfluid, _adam)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        _run(exe, main, loss, feeds[:3])
        tfluid.save(main, path)
        expect = _run(exe, main, loss, feeds[3:])
    for ext in (".pdparams", ".pdopt", ".pdmodel"):
        assert os.path.exists(path + ext)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.load(main, path)
        got = _run(exe, main, loss, feeds[3:])
    np.testing.assert_allclose(got, expect, rtol=RESUME_RTOL)


def test_save_without_optimizer_writes_no_pdopt(tmp_path):
    path = os.path.join(str(tmp_path), "model")
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        tfluid.layers.fc(x, 2)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.save(main, path)
    assert os.path.exists(path + ".pdparams")
    assert not os.path.exists(path + ".pdopt")
    main2, startup2, _ = _small_net(tfluid, _sgd)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup2)
        tfluid.save(main2, path + "_sgd")
    assert os.path.exists(path + "_sgd.pdopt")  # learning_rate_0


def test_save_and_load_refuse_like_the_reference(tmp_path):
    path = os.path.join(str(tmp_path), "model")
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, startup, _ = _small_net(tfluid, _sgd)
    with pytest.raises(AssertionError):
        tfluid.save(main, str(tmp_path) + os.sep)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.save(main, path)
    # a load before the startup program; the executor= escape hatch
    with tfluid.scope_guard(tfluid.Scope()):
        with pytest.raises(RuntimeError, match="startup"):
            tfluid.load(main, path)
        tfluid.load(main, path, executor=exe)
        for v in main.list_vars():
            if isinstance(v, tfluid.framework.Parameter):
                got = tfluid.global_scope().find_var(v.name)
                assert got is not None and got.get_tensor()._is_initialized()
    # same parameter names, another width
    main2, startup2 = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main2, startup2):
        x = tfluid.layers.data("x", shape=[4])
        tfluid.layers.fc(x, 16)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup2)
        with pytest.raises(AssertionError, match="[Ss]hape"):
            tfluid.load(main2, path)
    # a missing .pdopt for a program with optimizer state
    os.remove(path + ".pdopt")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with pytest.raises(AssertionError, match="Optimizer"):
            tfluid.load(main, path)


def test_program_state_roundtrip_and_unused_keys(tmp_path):
    path = os.path.join(str(tmp_path), "model")
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, startup, loss = _small_net(
        tfluid, lambda p: p.optimizer.Momentum(0.01, 0.9))
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        _run(exe, main, loss, _feeds(1))
        saved = {v.name: tfluid.global_scope().find_var(v.name)
                 .get_tensor().numpy()
                 for v in main.list_vars() if v.persistable and not v.is_data}
        tfluid.save(main, path)
    state = tfluid.load_program_state(path)
    assert set(saved) <= set(state)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tfluid.set_program_state(main, dict(state,
                                                not_a_var=np.zeros(3, "f")))
        assert any("not_a_var" in str(x.message) for x in w)
        for k, v in saved.items():
            np.testing.assert_array_equal(
                tfluid.global_scope().find_var(k).get_tensor().numpy(), v)


# -- across the packages ------------------------------------------------------


def _save(pkg, how, exe, main, startup, loss, dirname):
    if how == "save":
        pkg.save(main, os.path.join(dirname, "model"))
    elif how == "persistables":
        pkg.io.save_persistables(exe, dirname, main)
    elif how == "params_vars":
        pkg.io.save_params(exe, dirname, main, filename="params.npz")
        opt = [v for v in main.list_vars() if v.persistable
               and not v.is_data
               and not isinstance(v, pkg.framework.Parameter)]
        pkg.io.save_vars(exe, dirname, main, vars=opt, filename="opt.npz")
    else:
        pkg.io.save_train_model(dirname, ["x", "y"], [loss], exe, main,
                                startup)


def _load(pkg, how, exe, main, loss, dirname):
    """-> (program, loss name) the reader steps: its own program, or for
    ``train_model`` the bundle's (the writer's, optimizer ops fused)."""
    if how == "save":
        pkg.load(main, os.path.join(dirname, "model"), exe)
    elif how == "persistables":
        pkg.io.load_persistables(exe, dirname, main)
    elif how == "params_vars":
        pkg.io.load_params(exe, dirname, main, filename="params.npz")
        pkg.io.load_vars(exe, dirname, main,
                         predicate=lambda v: v.persistable
                         and not isinstance(v, pkg.framework.Parameter),
                         filename="opt.npz")
    else:
        m, s, feeds, fetches = pkg.io.load_train_model(dirname)
        assert feeds == ["x", "y"] and len(fetches) == 1
        exe.run(s)
        pkg.io.load_persistables(exe, dirname, m)
        return m, fetches[0]
    return main, loss


@pytest.mark.parametrize("how", ["save", "persistables", "params_vars",
                                 "train_model"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_cross_the_packages(tmp_path, writer, how):
    """Two Adam steps in the writer, a checkpoint, then the next step in
    the reader from a fresh scope against the writer's next step."""
    reader = "port" if writer == "ref" else "ref"
    wp, rp = PKGS[writer], PKGS[reader]
    feeds = _feeds(3)
    dirname = str(tmp_path)
    wexe = wp.Executor(wp.CPUPlace())
    main, startup, loss = _small_net(wp, _adam)
    with wp.scope_guard(wp.Scope()):
        wexe.run(startup)
        _run(wexe, main, loss, feeds[:2])
        _save(wp, how, wexe, main, startup, loss, dirname)
        want = _run(wexe, main, loss, feeds[2:])
    rexe = rp.Executor(rp.CPUPlace())
    rmain, rstartup, rloss = _small_net(rp, _adam)
    with rp.scope_guard(rp.Scope()):
        rexe.run(rstartup)
        prog, fetch = _load(rp, how, rexe, rmain, rloss, dirname)
        got = _run(rexe, prog, fetch, feeds[2:])
    np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)


# -- the surface --------------------------------------------------------------

PORTED = ["Program", "program_guard", "default_main_program",
          "default_startup_program", "CPUPlace", "CUDAPlace",
          "CUDAPinnedPlace", "cpu_places", "cuda_places", "Executor",
          "global_scope", "scope_guard", "Scope", "CompiledProgram",
          "BuildStrategy", "ExecutionStrategy", "ParallelExecutor",
          "ParamAttr", "layers", "nets", "optimizer", "initializer",
          "regularizer", "clip", "backward", "append_backward", "contrib",
          "io", "inference", "DataFeeder", "DataLoader", "PyReader", "batch",
          "datasets", "metrics", "average", "evaluator", "lod_tensor",
          "LoDTensor", "unique_name", "set_flags", "get_flags", "data",
          "core", "save", "load", "load_program_state", "set_program_state",
          "save_inference_model", "load_inference_model", "one_hot",
          "embedding", "create_lod_tensor", "create_random_int_lodtensor",
          "Variable", "in_dygraph_mode", "AnalysisConfig", "reader",
          "input", "parallel_executor", "distributed"]
WAITING = {"dygraph": "A9", "transpiler": "A9",
           "DistributeTranspiler": "A9", "DatasetFactory": "A9",
           "profiler": "A9", "parallel": "A9", "gradients": "A7",
           "create_paddle_predictor": "A6"}


@pytest.mark.parametrize("name", PORTED)
def test_surface_has_the_reference_name(name):
    assert hasattr(fluid, name)
    assert getattr(tfluid, name) is not None


@pytest.mark.parametrize("name", sorted(WAITING))
def test_surface_names_still_to_come_raise_by_roadmap_item(name):
    assert hasattr(fluid, name)
    with pytest.raises(AttributeError, match=WAITING[name]):
        getattr(tfluid, name)
    with pytest.raises(AttributeError, match="CUDA"):
        tfluid.TPUPlace
    assert not hasattr(tfluid, "no_such_name")


def test_fluid_data_declares_the_reference_variable():
    out = {}
    for name, pkg in PKGS.items():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            pkg.data("img", shape=[-1, 3, 8, 8])
            pkg.data("ids", shape=[-1, 5], dtype="int64", lod_level=1)
        out[name] = main.to_dict()
    assert out["port"] == out["ref"]


def test_compiled_program_runs_the_inner_program():
    main, startup, loss = _small_net(tfluid, _sgd)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feeds(1)[0]
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        compiled = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=tfluid.BuildStrategy(),
            exec_strategy=tfluid.ExecutionStrategy(),
            places=tfluid.cpu_places(1))
        a = _run(exe, compiled, loss, [feed])
        b = _run(exe, main, loss, [feed])
        pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                     main_program=main,
                                     scope=tfluid.global_scope())
        c = float(pe.run([loss], feed=feed)[0][0])
    assert a[0] > b[0] > c  # one program, three SGD steps
    with pytest.raises(NotImplementedError, match="A8"):
        tfluid.CompiledProgram(main).with_data_parallel(
            places=tfluid.cpu_places(2))
    with pytest.raises(NotImplementedError, match="A8"):
        tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                num_trainers=2)
    inference = tfluid.CompiledProgram(main).with_inference_optimize(None)
    assert inference._program is main
