"""Initializers that emit init ops into the startup program: the subset of
``paddle_tpu/initializer.py`` that ``fc``, ``embedding``, the conv and
the norm layers use by default (Constant, Uniform, Normal, Xavier)."""

import math

from .framework import default_startup_program
from .ops.common import dtype_enum

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "Xavier",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer"]


class Initializer:
    _seed = 0

    def __call__(self, var, block=None):
        raise NotImplementedError

    @staticmethod
    def _startup_block(block):
        return block if block is not None \
            else default_startup_program().global_block()

    @staticmethod
    def _declare(var, block):
        """Mirror the var into the startup block so the init op validates."""
        if not block.has_var(var.name):
            block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                             persistable=var.persistable)

    def _resolve_seed(self, block):
        """An explicit seed wins; else a program seed is keyed by the op's
        position, so same-shape parameters draw differently; 0 means the
        executor derives the stream (as in the reference)."""
        if self._seed:
            return self._seed
        prog_seed = block.program.random_seed or 0
        if prog_seed:
            return ((prog_seed * 1000003 + len(block.ops) + 1)
                    & 0x7FFFFFFF) or 1
        return 0

    def _append_uniform(self, var, block, low, high):
        return block.append_op(
            type="uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_enum(var.dtype),
                   "min": low, "max": high,
                   "seed": self._resolve_seed(block)})


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        return block.append_op(
            type="fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_enum(var.dtype),
                   "value": float(self._value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        return self._append_uniform(var, block, self._low, self._high)


class NormalInitializer(Initializer):
    """N(loc, scale^2) through the ``gaussian_random`` op (the default
    of ``layers.conv2d`` and ``conv2d_bn_relu``: scale sqrt(2 / fan_in))."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_enum(var.dtype),
                   "mean": self._mean, "std": self._std,
                   "seed": self._resolve_seed(block)})


def _fan_in_out(shape):
    if len(shape) < 2:
        n = int(shape[0]) if shape else 1
        return n, n
    receptive = 1
    for d in shape[2:]:
        receptive *= int(d)
    if len(shape) > 2:  # conv weights [out_c, in_c, kh, kw]
        return int(shape[1]) * receptive, int(shape[0]) * receptive
    return int(shape[0]), int(shape[1])


class XavierInitializer(Initializer):
    """Uniform Xavier/Glorot (the only form the slice's layers use)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        if not uniform:
            raise NotImplementedError(
                "normal Xavier (gaussian_random) is not ported yet")
        self._fan_in, self._fan_out, self._seed = fan_in, fan_out, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        fi, fo = _fan_in_out(var.shape)
        fan_in = self._fan_in if self._fan_in is not None else fi
        fan_out = self._fan_out if self._fan_out is not None else fo
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return self._append_uniform(var, block, -limit, limit)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
