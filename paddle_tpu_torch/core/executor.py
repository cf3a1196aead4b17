"""Executor: runs Programs op by op in eager PyTorch on one device.

Counterpart of ``paddle_tpu/core/executor.py`` (``global_scope:52``,
``scope_guard:59``, ``Executor.run:427``,
``_maybe_fuse_optimizers:1033``).  ``run`` first fuses a training
program's optimizer ops (once per program version), then builds a
``BlockPlan`` per (program, version, feed shapes and dtypes, fetch list)
and caches it; parameters come from the Scope, the ops launch their
kernels on the executor's device (a control-flow op runs its sub-block
through the step's ``lowering.StepRunner``), and persistables the block
writes (the startup program's initialisers; a training step's
parameters, moments and beta pows, velocities, BN running statistics)
are stored back.  No
``torch.compile``: each op's lowering runs as written.

Each ``run`` is one ``executor.step`` span (``core/tracing.py``; under
whatever span is active on the calling thread, such as the serving
dispatcher's ``serving.execute``) followed by a ``step`` instant, and one
``telemetry.record_step`` (``executor_steps_total``, the cache hit or miss,
``executor_step_ms``, ``executor_compile_ms``, the feed and fetch bytes,
and the ``step`` event).  The step time is the host's time to issue the
ops and store the persistables back: the card runs them asynchronously
and the step path adds no ``torch.cuda.synchronize``, so a step's kernels
may still run after it (the fetch's copy to the host waits for them).  On
a plan miss ``compile_ms`` is the plan's build time; nothing is compiled,
so the reference's ``executor.compile`` and ``executor.cache_restore``
spans have no counterpart.  ``warmup`` is an ``executor.warmup`` span.
"""

import contextlib
import threading
import time

import numpy as np
import torch

from .. import flags
from ..device import resolve_device, set_f32_numerics
from ..framework import Variable, default_main_program, dtype_to_torch
from . import telemetry as _telemetry
from . import tracing as _tracing
from .lowering import MASTER_SUFFIX, BlockPlan, StepRunner, run_op
from .scope import Scope

__all__ = ["Executor", "global_scope", "scope_guard", "place_device"]

_global_scope = Scope()
# per-thread override: threads that never call scope_guard see the main
# thread's current scope
_scope_tls = threading.local()
_RNG_LOCK = threading.Lock()


def _is_main_thread():
    return threading.current_thread() is threading.main_thread()


def global_scope():
    if not _is_main_thread() and getattr(_scope_tls, "scope", None) \
            is not None:
        return _scope_tls.scope
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    if _is_main_thread():
        old, _global_scope = _global_scope, scope
        try:
            yield
        finally:
            _global_scope = old
    else:
        old = getattr(_scope_tls, "scope", None)
        _scope_tls.scope = scope
        try:
            yield
        finally:
            _scope_tls.scope = old


def place_device(place=None):
    """torch device of a place: None -> the card, ``CPUPlace()`` -> cpu,
    ``CUDAPlace(i)`` -> cuda:i; a device or its name passes through."""
    if place is not None and hasattr(place, "torch_device"):
        place = place.torch_device()
    return resolve_device(place)


def _fetch_name(f):
    if isinstance(f, Variable):
        return f.name
    if isinstance(f, str):
        return f
    raise TypeError("bad fetch target %r" % (f,))


def _nbytes(value):
    if isinstance(value, torch.Tensor):
        return value.element_size() * value.numel()
    return int(getattr(value, "nbytes", 0))


def _gather_carry(scope, plan, env):
    """{name: bf16 copy} of the plan's carried params, from the scope's
    cache where it still mirrors the master, else cast afresh; each copy
    goes into ``env`` under the param's name and the master under
    ``<name>@MASTER``."""
    if not plan.carry_names:
        return None
    cache = scope.__dict__.setdefault("_layout_carry_cache", {})
    carry = {}
    for n in plan.carry_names:
        master = env[n]
        hit = cache.get(n)
        if hit is not None and hit[0] is master \
                and hit[1] == master._version:
            bf = hit[2]
        else:
            bf = master.to(torch.bfloat16)
            cache[n] = (master, master._version, bf)
        carry[n] = env[n] = bf
        env[n + MASTER_SUFFIX] = master
    return carry


def _store_carry(scope, env, carry, written):
    """After the step: each carried param's copy of its new master (the
    optimizer's own where it wrote one), cached against the master the
    scope now holds.  A param no op wrote keeps its copy."""
    cache = scope.__dict__["_layout_carry_cache"]
    for n, bf in carry.items():
        value = env[n]  # the new f32 master (ParamOut), else the copy
        if value.dtype == torch.bfloat16:
            continue
        if n not in written:
            bf = value.to(torch.bfloat16)
        cache[n] = (value, value._version, bf)


class Executor:
    """Runs programs on one device (``place=None``: the CUDA card).  A
    training program's sgd, momentum or adam ops are coalesced into one
    fused_sgd / fused_momentum / fused_adam before its first plan, as the
    reference does by default (FLAGS_fuse_optimizer_ops)."""

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)
        if self.device.type == "cuda":
            set_f32_numerics()
        self._cache = {}
        self._fuse_attempted = set()
        # the last step's host reads of device values by control-flow ops
        # (predicates, loop conditions, list-array indices, prints)
        self.last_host_syncs = 0

    def _maybe_fuse_optimizers(self, program, feed_names, fetch_names):
        """Horizontal optimizer fusion before planning, tried once per
        (program, version): one fused update instead of one launch per
        parameter.  The pass bumps the version when it fuses, so the plan
        that follows is of the fused program."""
        key = (program._uid, program.version)
        if key in self._fuse_attempted:
            return
        self._fuse_attempted.add(key)
        block = program.global_block()
        if sum(op.type in ("sgd", "momentum", "adam")
               for op in block.ops) < 4:
            return
        from .. import ir

        ir.apply_pass("fuse_optimizer_ops_pass", program, None,
                      protected=set(feed_names) | set(fetch_names))
        self._fuse_attempted.add((program._uid, program.version))

    def _plan(self, program, feeds, fetch_names):
        allow_carry = bool(flags.flag("FLAGS_layout_match_params"))
        key = (program._uid, program.version,
               tuple(sorted((n, tuple(t.shape), str(t.dtype))
                            for n, t in feeds.items())),
               tuple(fetch_names), allow_carry)
        plan = self._cache.get(key)
        cached = plan is not None
        if not cached:
            plan = BlockPlan(program.global_block(), list(feeds),
                             fetch_names, allow_carry=allow_carry)
            self._cache[key] = plan
        return plan, cached

    def _to_device(self, name, value, block):
        """A feed or scope value as a tensor on this device, in the dtype
        its variable declares."""
        v = block._find_var_recursive(name)
        dtype = dtype_to_torch(v.dtype) if v is not None and v.dtype \
            else None
        if not isinstance(value, torch.Tensor):
            # on the CPU a copy, never a view of the caller's array: the
            # update ops write the scope's tensors in place
            value = torch.from_numpy(np.array(value)
                                     if self.device.type == "cpu"
                                     else np.ascontiguousarray(value))
        return value.to(device=self.device, dtype=dtype)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block once; returns the fetches as
        numpy arrays (or device tensors with ``return_numpy=False``)."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [_fetch_name(f) for f in fetch_list or []]
        block = program.global_block()
        env = {n: self._to_device(n, v, block)
               for n, v in (feed or {}).items()}
        self._maybe_fuse_optimizers(program, list(env), fetch_names)
        t_plan = time.perf_counter()
        plan, cached = self._plan(program, env, fetch_names)
        build_ms = (time.perf_counter() - t_plan) * 1e3
        feeds = set(env)
        for n in plan.external:
            var = scope.find_var(n)
            if var is None or not var.get_tensor()._is_initialized():
                raise RuntimeError(
                    "variable %r is not initialized in scope: run the "
                    "startup program first" % n)
            val = var.get_tensor().get()
            if not isinstance(val, torch.Tensor) \
                    or val.device != self.device:
                val = self._to_device(n, val, block)
                var.set(val)  # the scope keeps the device copy
            env[n] = val
        carry = _gather_carry(scope, plan, env)
        carry_written = set()
        seed = program.random_seed or 0
        with _RNG_LOCK:
            step = scope._rng_counter
            scope._rng_counter = step + 1
        # the feeds and the scope's values are data-dependent
        runner = StepRunner(plan, self.device, seed, step, carry,
                            carry_written,
                            set(env) if plan.track_dyn else None, run_op)
        t_step = time.perf_counter()
        with _tracing.span("executor.step", step=int(step),
                           cache_hit=cached), torch.no_grad():
            runner.run(plan, env)
            for n in plan.persist_written:
                if n in env and n not in feeds:
                    scope.var(n).set(env[n])
            if carry:
                _store_carry(scope, env, carry, carry_written)
        step_ms = (time.perf_counter() - t_step) * 1e3
        self.last_host_syncs = runner.host_syncs
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch targets %s were never produced" % missing)
        fetches = [env[n] for n in fetch_names]
        if _telemetry.enabled():
            _telemetry.record_step(
                step_ms, cached, compile_ms=None if cached else build_ms,
                feed_bytes=sum(_nbytes(v) for v in (feed or {}).values()),
                fetch_bytes=sum(_nbytes(f) for f in fetches),
                host_syncs=runner.host_syncs)
        _tracing.instant("step", step=int(step))
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return fetches

    def warmup(self, program=None, feed_specs=None, fetch_list=None,
               scope=None):
        """Run ``program`` once on zero feeds of the given
        ``{name: (shape, dtype or None)}`` so its kernels are built and
        the libraries' first-call costs are paid before traffic.  Returns
        ``{"source": "compiled"|"memory", "compile_ms", "key": None}`` as
        the reference does: "memory" when a plan for this signature
        already existed."""
        program = program if program is not None else default_main_program()
        block = program.global_block()
        feed = {}
        for name, (shape, dt) in (feed_specs or {}).items():
            v = block._find_var_recursive(name)
            dtype = dtype_to_torch(dt or (v.dtype if v is not None
                                          else "float32"))
            feed[name] = torch.zeros(tuple(shape), dtype=dtype,
                                     device=self.device)
        fetch_names = [_fetch_name(f) for f in fetch_list or []]
        with _tracing.span("executor.warmup"):
            self._maybe_fuse_optimizers(program, list(feed), fetch_names)
            _plan, cached = self._plan(program, feed, fetch_names)
            t0 = time.perf_counter()
            self.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                     return_numpy=False)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"source": "memory" if cached else "compiled",
                "compile_ms": (time.perf_counter() - t0) * 1e3, "key": None}

