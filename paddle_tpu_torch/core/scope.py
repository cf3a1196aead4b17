"""Scope: name -> value map whose values are torch tensors on the
executor's device.  Counterpart of ``paddle_tpu/core/scope.py``."""

import numpy as np
import torch

__all__ = ["Scope", "Tensor", "scope_from_numpy", "scope_to_numpy"]


class Tensor:
    """Value holder of one scope variable (a torch tensor or None)."""

    __slots__ = ("_value",)

    def __init__(self, value=None):
        self._value = value

    def set(self, value, place=None):
        self._value = value

    def get(self):
        return self._value

    def numpy(self):
        if self._value is None:
            raise RuntimeError("tensor is uninitialized")
        v = self._value
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                v = v.float()
            # a copy on the CPU too: the update ops write their state in
            # place, which would change an array that shared its memory
            out = v.detach().cpu().numpy()
            return out.copy() if v.device.type == "cpu" else out
        return np.asarray(v)

    def _is_initialized(self):
        return self._value is not None


class _ScopeVar:
    __slots__ = ("name", "tensor")

    def __init__(self, name):
        self.name = name
        self.tensor = Tensor()

    def get_tensor(self):
        return self.tensor

    def set(self, value):
        self.tensor.set(value)


class Scope:
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        # executor bookkeeping: steps run against this scope, which keys
        # the generators of random ops
        self._rng_counter = 0

    def var(self, name):
        """Find or create a variable in THIS scope."""
        v = self._vars.get(name)
        if v is None:
            v = _ScopeVar(name)
            self._vars[name] = v
        return v

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None


def _persistable_vars(program):
    return [v for v in program.list_vars() if v.persistable and not v.is_data]


def scope_from_numpy(scope, arrays, device, program=None):
    """Set ``{name: ndarray}`` into ``scope`` as tensors on ``device`` (a
    torch device or name).  With ``program``, the arrays are its
    persistables (parameters and optimizer state: moments, beta pows,
    velocities, learning rate; a batch norm's running mean and variance;
    conv filters like any parameter), each must be given and each is set
    in the dtype its variable declares; this is how a JAX scope's
    training state (the optimizers' accumulators, the EMA, ModelAverage
    and Lookahead buffers and the LR schedules' step counter included)
    is carried into the port.  The tensors are copies: the arrays stay
    as they are whatever the steps do."""
    from ..framework import dtype_to_torch

    dev = torch.device(device)
    dtypes = {}
    if program is not None:
        dtypes = {v.name: dtype_to_torch(v.dtype)
                  for v in _persistable_vars(program)}
        missing = sorted(set(dtypes) - set(arrays))
        if missing:
            raise KeyError("no array for persistables %s" % missing[:8])
        arrays = {n: arrays[n] for n in dtypes}
    for name, arr in arrays.items():
        # a copy: the update ops write the scope's tensors in place
        t = torch.from_numpy(np.array(arr))
        scope.var(name).set(t.to(device=dev, dtype=dtypes.get(name,
                                                              t.dtype)))
    return scope


def scope_to_numpy(scope, program):
    """{name: ndarray} of ``program``'s persistables found in ``scope``."""
    out = {}
    for v in _persistable_vars(program):
        sv = scope.find_var(v.name)
        if sv is not None and sv.get_tensor()._is_initialized():
            out[v.name] = sv.get_tensor().numpy()
    return out
