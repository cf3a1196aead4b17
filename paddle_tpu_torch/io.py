"""Inference-model and persistable save/load in the JAX package's format.

Counterpart of ``paddle_tpu/io.py`` (``_prune_for_inference:160``,
``save_inference_model:196``, ``load_inference_model:225``,
``save/load_persistables``): a directory holds ``__model__.json`` (the
JSON program IR plus feed and fetch names) and ``__params__.npz`` (one
array per persistable).  A directory saved by either package loads into
the other.  The reference's protobuf format (``legacy_format``) is not
ported yet.
"""

import json
import os

import numpy as np
import torch

from .core.executor import global_scope, place_device
from .framework import (OP_ROLE_KEY, OpRole, Program, Variable,
                        default_main_program)

__all__ = ["save_persistables", "load_persistables", "save_inference_model",
           "load_inference_model"]


def _is_persistable(var):
    return var.persistable and not var.is_data


def _atomic_save(path, arrays):
    """Write via a temp file and a rename, so ``path`` is complete or
    absent."""
    tmp = "%s._tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


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
    _atomic_save(path, out)
    return path


def save_persistables(executor, dirname, main_program=None, filename=None):
    return _gather(dirname, main_program, _is_persistable, filename)


def _scatter(executor, dirname, program, predicate, filename):
    """Load matching arrays into the global scope as tensors on the
    executor's device (the card when the executor is None)."""
    program = program or default_main_program()
    dev = executor.device if executor is not None else place_device(None)
    scope = global_scope()
    path = os.path.join(dirname, filename or "__params__.npz")
    loaded = 0
    with np.load(path, allow_pickle=False) as data:
        for var in program.list_vars():
            if predicate(var) and var.name in data.files:
                scope.var(var.name).set(torch.from_numpy(
                    np.ascontiguousarray(data[var.name])).to(dev))
                loaded += 1
    return loaded


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
