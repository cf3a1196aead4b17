"""Checkpoints and inference models in the JAX package's formats.

Counterpart of ``paddle_tpu/io.py``: ``save_vars`` / ``save_params`` /
``save_persistables`` and their ``load_*`` (``:113-156``; one ``.npz``,
``__params__.npz`` unless ``filename`` names another, one array per
variable), ``save_inference_model`` / ``load_inference_model``
(``_prune_for_inference:160``, ``:196``, ``:225``; ``__model__.json``, the
JSON program IR plus feed and fetch names), ``save_train_model`` /
``load_train_model`` (``:366-405``; ``__train_model__.json`` with the main
and startup programs), and Fluid 1.6's single-call training state,
``save`` / ``load`` / ``load_program_state`` / ``set_program_state``
(``:945-1068``): pickled name -> ndarray dicts in ``<path>.pdparams`` and
``<path>.pdopt`` (written only when the program has optimizer state) and
the JSON IR in ``<path>.pdmodel``.  Files written by either package load
into the other.  Loads put tensors on the executor's device (the card
when there is no executor, or the device of the tensor they replace).

Neither package saves the executor's step counter (``scope._rng_counter``,
which keys the dropout stream): a run resumed from a checkpoint draws the
masks of steps 0, 1, ... again, as the reference's does.

Not here: the protobuf format (``legacy_format``) and ``CheckpointManager``
(sharded and elastic, with the collectives).
"""

import json
import os
import pickle
import warnings

import numpy as np
import torch

from .core.executor import global_scope, place_device
from .framework import (OP_ROLE_KEY, OpRole, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        dtype_to_torch)
from .utils.fault_injection import maybe_fail

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "save_train_model", "load_train_model",
           "save", "load", "load_program_state", "set_program_state",
           "DataLoader", "PyReader"]


def __getattr__(name):  # lazy: the reader imports after io
    if name in ("DataLoader", "PyReader"):
        from . import reader

        return getattr(reader, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def _is_persistable(var):
    return var.persistable and not var.is_data


def _is_parameter(var):
    return isinstance(var, Parameter)


def _is_belong_to_optimizer(var):
    """Persistable state that is not a Parameter: optimizer accumulators,
    LR counters (Fluid's io.py:109)."""
    return _is_persistable(var) and not isinstance(var, Parameter)


def _atomic_write(path, write_fn, mode="wb"):
    """Write via a temp file and a rename, so ``path`` is complete or
    absent.  The ``ckpt.write`` fault point sits between the two: an
    injected kill leaves only the temp file."""
    tmp = "%s._tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, mode) as f:
            write_fn(f)
        maybe_fail("ckpt.write")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _names_predicate(vars):
    names = {v.name if isinstance(v, Variable) else v for v in vars}
    return lambda v: v.name in names


def _gather(dirname, program, predicate, filename):
    program = program or default_main_program()
    scope = global_scope()
    out = {}
    for var in program.list_vars():
        if not predicate(var):
            continue
        sv = scope.find_var(var.name)
        if sv is None or not sv.get_tensor()._is_initialized():
            continue
        out[var.name] = sv.get_tensor().numpy()
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, filename or "__params__.npz")
    _atomic_write(path, lambda f: np.savez(f, **out))
    return path


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """The variables named by ``vars`` (or those ``predicate`` accepts)."""
    if vars is not None:
        predicate = _names_predicate(vars)
    return _gather(dirname, main_program, predicate, filename)


def save_params(executor, dirname, main_program=None, filename=None):
    return _gather(dirname, main_program, _is_parameter, filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return _gather(dirname, main_program, _is_persistable, filename)


def _device_of(executor):
    return executor.device if executor is not None else place_device(None)


def _tensor(arr, var, dev):
    """A copy of ``arr`` on ``dev`` in the dtype ``var`` declares."""
    t = torch.from_numpy(np.array(arr))
    dtype = dtype_to_torch(var.dtype) if var.dtype else t.dtype
    return t.to(device=dev, dtype=dtype)


def _scatter(executor, dirname, program, predicate, filename):
    """Load matching arrays into the global scope as tensors on the
    executor's device (the card when the executor is None)."""
    program = program or default_main_program()
    dev = _device_of(executor)
    scope = global_scope()
    path = os.path.join(dirname, filename or "__params__.npz")
    loaded = 0
    with np.load(path, allow_pickle=False) as data:
        for var in program.list_vars():
            if predicate(var) and var.name in data.files:
                scope.var(var.name).set(_tensor(data[var.name], var, dev))
                loaded += 1
    return loaded


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    if vars is not None:
        predicate = _names_predicate(vars)
    return _scatter(executor, dirname, main_program, predicate, filename)


def load_params(executor, dirname, main_program=None, filename=None):
    return _scatter(executor, dirname, main_program, _is_parameter, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return _scatter(executor, dirname, main_program, _is_persistable,
                    filename)


def _prune_for_inference(program, feed_names, target_names):
    """Keep the ops needed to compute the targets (a backward slice over
    the op list, backward/optimize/lr-schedule ops dropped), in a clone
    with ``is_test`` set."""
    block = program.global_block()
    needed = set(target_names)
    keep = []
    for op in reversed(block.ops):
        role = int(op.attr(OP_ROLE_KEY) or 0)
        if role & (OpRole.Backward | OpRole.Optimize) \
                or role == OpRole.LRSched:
            continue
        if not any(n in needed for n in op.output_arg_names if n):
            continue
        keep.append(op)
        needed.update(n for n in op.input_arg_names if n)

    def key(op):
        return (op.type, json.dumps(op.inputs, sort_keys=True),
                json.dumps(op.outputs, sort_keys=True))

    kept = {key(op) for op in keep}
    pruned = program.clone(for_test=True)
    pb = pruned.global_block()
    pb.ops = [op for op in pb.ops if key(op) in kept]
    pruned._bump_version()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    program = main_program or default_main_program()
    target_names = [v.name if isinstance(v, Variable) else v
                    for v in target_vars]
    pruned = _prune_for_inference(program, feeded_var_names, target_names)
    os.makedirs(dirname, exist_ok=True)
    model = {"program": pruned.to_dict(),
             "feed_names": list(feeded_var_names),
             "fetch_names": target_names}
    with open(os.path.join(dirname, model_filename or "__model__.json"),
              "w") as f:
        json.dump(model, f)
    if not program_only:
        save_persistables(executor, dirname, pruned, params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """-> (program, feed names, fetch variables), the persistables loaded
    into the global scope on ``executor``'s device."""
    path = os.path.join(dirname, model_filename or "__model__.json")
    with open(path) as f:
        model = json.load(f)
    program = Program.from_dict(model["program"])
    params = os.path.join(dirname, params_filename or "__params__.npz")
    if os.path.exists(params):
        load_persistables(executor, dirname, program, params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_vars


def save_train_model(dirname, feed_names, fetch_vars, executor,
                     main_program=None, startup_program=None):
    """A training bundle: ``__train_model__.json`` with the main and
    startup programs and the feed and fetch names, and, with an executor,
    the persistables beside it."""
    main = main_program or default_main_program()
    startup = startup_program or default_startup_program()
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in fetch_vars]
    os.makedirs(dirname, exist_ok=True)
    bundle = {"main_program": main.to_dict(),
              "startup_program": startup.to_dict(),
              "feed_names": list(feed_names),
              "fetch_names": fetch_names}
    with open(os.path.join(dirname, "__train_model__.json"), "w") as f:
        json.dump(bundle, f)
    if executor is not None:
        save_persistables(executor, dirname, main)
    return fetch_names


def load_train_model(dirname, executor=None):
    """-> (main, startup, feed names, fetch names) of a bundle."""
    with open(os.path.join(dirname, "__train_model__.json")) as f:
        bundle = json.load(f)
    return (Program.from_dict(bundle["main_program"]),
            Program.from_dict(bundle["startup_program"]),
            bundle["feed_names"], bundle["fetch_names"])


# -- fluid.save / fluid.load (Fluid 1.6's single-call training state) --------


def save(program, model_path):
    """Parameters into ``model_path + ".pdparams"``, the optimizer state
    into ``".pdopt"`` (only when there is some: SGD has none) and the
    program into ``".pdmodel"`` (Fluid's io.py:1493)."""
    base_name = os.path.basename(model_path)
    if base_name == "":
        raise AssertionError(
            "model_path MUST be format of dirname/filename, Now filename is "
            "empty str")
    dirname = os.path.dirname(model_path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    scope = global_scope()

    def get_tensor(var):
        sv = scope.find_var(var.name)
        if sv is None or not sv.get_tensor()._is_initialized():
            raise AssertionError(
                "variable %r is not initialized; run the startup program "
                "before fluid.save" % var.name)
        return sv.get_tensor().numpy()

    param_dict = {v.name: get_tensor(v)
                  for v in program.list_vars() if _is_parameter(v)}
    _atomic_write(model_path + ".pdparams",
                  lambda f: pickle.dump(param_dict, f))
    opt_dict = {v.name: get_tensor(v)
                for v in program.list_vars() if _is_belong_to_optimizer(v)}
    if opt_dict:
        _atomic_write(model_path + ".pdopt",
                      lambda f: pickle.dump(opt_dict, f))
    _atomic_write(model_path + ".pdmodel",
                  lambda f: json.dump(program.to_dict(), f), mode="w")


def _canon(dtype):
    return {"int64": "int32", "float64": "float32"}.get(np.dtype(dtype).name,
                                                        np.dtype(dtype).name)


def _check_var_match(var_name, old_np, new_np):
    """The shape and dtype guard of ``load`` and ``set_program_state``."""
    if tuple(old_np.shape) != tuple(new_np.shape):
        raise AssertionError(
            "Shape not matching: the Program requires a parameter with a "
            "shape of ({}), while the loaded parameter (namely [ {} ]) has a "
            "shape of ({}).".format(tuple(old_np.shape), var_name,
                                    tuple(new_np.shape)))
    # 64-bit arrays match their 32-bit kin: the reference's JAX runs the
    # IR's int64 as int32 and saves it so, and either package's file loads
    # into the other
    if _canon(old_np.dtype) != _canon(new_np.dtype):
        raise AssertionError(
            "Dtype not matching: the Program requires a parameter with a "
            "dtype of ({}), while the loaded parameter (namely [ {} ]) has a "
            "dtype of ({}).".format(old_np.dtype, var_name, new_np.dtype))


def _read_pickle(path, what):
    if not os.path.exists(path):
        raise AssertionError("{} file [{}] not exits".format(what, path))
    with open(path, "rb") as f:
        return pickle.load(f)


def load(program, model_path, executor=None):
    """Restore what ``save`` wrote into the global scope, shapes and dtypes
    checked (Fluid's io.py:1547).  Without ``executor`` the startup program
    must have run, and each tensor stays on the device of the one it
    replaces; with one, missing tensors are made on its device."""
    scope = global_scope()

    def set_var(var, nd):
        sv = scope.find_var(var.name)
        if sv is None or not sv.get_tensor()._is_initialized():
            if executor is None:
                raise RuntimeError(
                    "Variable [ %s ] is not initialized in the scope; run "
                    "the startup program before fluid.load, or pass "
                    "executor= to create it" % var.name)
            dev = executor.device
        else:
            _check_var_match(var.name, sv.get_tensor().numpy(),
                             np.asarray(nd))
            old = sv.get_tensor().get()
            dev = old.device if isinstance(old, torch.Tensor) \
                else _device_of(executor)
        scope.var(var.name).set(_tensor(nd, var, dev))

    pfile = model_path + ".pdparams"
    load_dict = _read_pickle(pfile, "Parameter")
    for v in program.list_vars():
        if not _is_parameter(v):
            continue
        if v.name not in load_dict:
            raise AssertionError("Can not find [{}] in model file [{}]"
                                 .format(v.name, pfile))
        set_var(v, load_dict[v.name])
    opt_vars = [v for v in program.list_vars() if _is_belong_to_optimizer(v)]
    if opt_vars:
        ofile = model_path + ".pdopt"
        load_dict = _read_pickle(ofile, "Optimizer")
        for v in opt_vars:
            if v.name not in load_dict:
                raise AssertionError("Can not find [{}] in model file [{}]"
                                     .format(v.name, ofile))
            set_var(v, load_dict[v.name])


def load_program_state(model_path):
    """-> one name -> ndarray dict of the parameters and the optimizer
    state (Fluid's io.py:1630)."""
    state = _read_pickle(model_path + ".pdparams", "Parameter")
    opt_file = model_path + ".pdopt"
    if os.path.exists(opt_file):
        with open(opt_file, "rb") as f:
            state.update(pickle.load(f))
    return state


def set_program_state(program, state_dict):
    """Set the program's persistables from ``state_dict``, shapes and
    dtypes checked, after the startup program ran; keys the program does
    not have are named in a warning (Fluid's io.py:1672)."""
    scope = global_scope()
    used = set()
    for var in program.list_vars():
        if not _is_persistable(var):
            continue
        sv = scope.find_var(var.name)
        if sv is None:
            raise AssertionError(
                "Variable [ {} ] Not found, Please make sure run startup "
                "program".format(var.name))
        if var.name not in state_dict:
            continue
        new_np = np.asarray(state_dict[var.name])
        _check_var_match(var.name, sv.get_tensor().numpy(), new_np)
        old = sv.get_tensor().get()
        dev = old.device if isinstance(old, torch.Tensor) \
            else place_device(None)
        scope.var(var.name).set(_tensor(new_np, var, dev))
        used.add(var.name)
    unused = [k for k in state_dict if k not in used]
    if unused:
        warnings.warn(
            "This list is not set, Because of Paramerter not found in "
            "program. There are: {}".format(" ".join(unused)))
