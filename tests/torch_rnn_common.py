"""Shared pieces of the recurrent-net parity tests (``test_torch_rnn_*``):
the two packages side by side, a run of a program in each from the
reference's initial weights, and one dropout mask for both.

The packages draw dropout from different streams, so ``patch_masks``
points every draw of both at one mask, a fixed function of the element
index (a multiplicative hash against the draw's own byte threshold):
the reference's ``dropout`` op (``ops.nn.bernoulli_bytes``) and its
``basic_*_rnn`` ops (``ops.contrib_rnn``: the step keys become (t, 0),
``fold_in`` sets the layer, and the draw hashes element ((t L + l) B +
b) H + h of the op's [T, L, B, H] block, traced under ``lax.scan``), and
the port's byte draw ``philox.keep_bytes``, which both its dropout op and
its one draw over an rnn op's [T, L, B, H] block go through.
"""

import types

import numpy as np
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.contrib as jcontrib
from paddle_tpu.ops import contrib_rnn as jcrnn
from paddle_tpu.ops import nn as jnn
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.framework as tfw
from paddle_tpu_torch import contrib as tcontrib
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import Executor, Scope, scope_from_numpy
from paddle_tpu_torch.kernels import philox
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.utils import unique_name as tun

J = types.SimpleNamespace(fw=fluid, L=fluid.layers, C=jcontrib,
                          opt=fluid.optimizer, un=jun,
                          init=fluid.initializer, ParamAttr=fluid.ParamAttr)
T = types.SimpleNamespace(fw=tfw, L=tlayers, C=tcontrib, opt=topt, un=tun,
                          init=tinit, ParamAttr=TParamAttr)

_MUL, _ADD = 0x9E3779B1, 0x7F4A7C15


def build(m, make, seed=None):
    """``make(m)`` -> (feeds, fetch) under fresh programs and names."""
    main, startup = m.fw.Program(), m.fw.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with m.un.guard(), m.fw.program_guard(main, startup):
        feeds, fetch = make(m)
    return main, startup, feeds, fetch


def run_j(main, startup, feeds, fetch):
    """The reference's fetches for each feed (one scope, in turn) and its
    initial persistables."""
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        init = {v.name: np.array(scope.find_var(v.name).get_tensor()
                                 .numpy())
                for v in main.list_vars() if v.persistable and not v.is_data
                and scope.find_var(v.name) is not None}
        outs = [[np.asarray(o) for o in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
    return outs, init


def run_t(main, init, feeds, fetch):
    """The port's fetches for each feed from the weights ``init``."""
    exe = Executor(tfw.CPUPlace())
    scope = scope_from_numpy(Scope(), init, "cpu", program=main)
    return [[np.asarray(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope)]
            for f in feeds]


def hash_keep(shape, thr32):
    """Keep iff hash(element index) < thr32 (a u32 threshold)."""
    n = int(np.prod(shape))
    h = (np.arange(n, dtype=np.uint64) * np.uint64(_MUL)
         + np.uint64(_ADD)) & np.uint64(0xFFFFFFFF)
    return (h < np.uint64(thr32)).reshape(tuple(int(d) for d in shape))


def _thr32(keep_prob):
    return min(max(int(round(float(keep_prob) * 256.0)), 0), 256) << 24


def patch_masks(monkeypatch, n_layers):
    """Every dropout draw of both packages -> ``hash_keep``; the rnn ops'
    blocks hashed as [T, ``n_layers``, B, H]."""
    bytes0 = jnn.bernoulli_bytes

    def jax_bytes(key, keep_prob, shape):
        if not all(isinstance(d, (int, np.integer)) for d in shape):
            return bytes0(key, keep_prob, shape)  # shape inference only
        return hash_keep(shape, _thr32(keep_prob))

    def step_keys(ctx, attrs, t_steps):
        return jnp.stack([jnp.arange(t_steps, dtype=jnp.uint32),
                          jnp.zeros(t_steps, jnp.uint32)], axis=1)

    def rnn_dropout(x, p, key, upscale):
        b, h = x.shape
        base = (key[0] * jnp.uint32(n_layers) + key[1]) * jnp.uint32(b * h)
        idx = base + jnp.arange(b * h, dtype=jnp.uint32).reshape(b, h)
        hashed = idx * jnp.uint32(_MUL) + jnp.uint32(_ADD)
        keep = hashed < jnp.uint32(_thr32(1.0 - p))
        kept = x / (1.0 - p) if upscale else x
        return jnp.where(keep, kept, 0.0).astype(x.dtype)

    fake_jax = types.SimpleNamespace(
        lax=jcrnn.jax.lax,
        random=types.SimpleNamespace(
            fold_in=lambda k, i: k.at[1].set(jnp.uint32(i))))
    monkeypatch.setattr(jnn, "bernoulli_bytes", jax_bytes)
    monkeypatch.setattr(jcrnn, "_step_keys", step_keys)
    monkeypatch.setattr(jcrnn, "_dropout", rnn_dropout)
    monkeypatch.setattr(jcrnn, "jax", fake_jax)
    monkeypatch.setattr(
        philox, "keep_bytes",
        lambda seed, thr, shape, device="cpu": torch.from_numpy(
            hash_keep(shape, thr << 24)).to(device))
