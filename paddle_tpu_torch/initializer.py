"""Initializers that emit init ops into the startup program.  Counterpart
of ``paddle_tpu/initializer.py``: Constant, Uniform, Normal,
TruncatedNormal (``:136``), Xavier (uniform and normal, ``:174``), MSRA
(``:215``), Bilinear (``:240``) and NumpyArray (``:260``).  The random
ones draw on the executor's device (``ops/creation.py``): the same op
and attrs as the reference's, other values from the same distribution;
Bilinear and NumpyArray write their values into an ``assign_value``
op, so they are exact."""

import math

import numpy as np

from .framework import default_startup_program
from .ops.common import dtype_enum

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "Xavier", "MSRA", "Bilinear", "NumpyArrayInitializer",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "BilinearInitializer"]


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

    def _append_normal(self, var, block, mean, std,
                       op_type="gaussian_random"):
        return block.append_op(
            type=op_type, outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": dtype_enum(var.dtype),
                   "mean": mean, "std": std,
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

    _op_type = "gaussian_random"

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        return self._append_normal(var, block, self._mean, self._std,
                                   self._op_type)


class TruncatedNormalInitializer(NormalInitializer):
    """N(loc, scale^2) truncated at 2 standard deviations
    (``truncated_gaussian_random``)."""

    _op_type = "truncated_gaussian_random"


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
    """Xavier/Glorot: U(+-sqrt(6 / (fan_in + fan_out))), or with
    ``uniform=False`` N(0, 2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in, self._fan_out, self._seed = fan_in, fan_out, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        fi, fo = _fan_in_out(var.shape)
        fan_in = self._fan_in if self._fan_in is not None else fi
        fan_out = self._fan_out if self._fan_out is not None else fo
        if self._uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return self._append_uniform(var, block, -limit, limit)
        return self._append_normal(var, block, 0.0,
                                   math.sqrt(2.0 / (fan_in + fan_out)))


class MSRAInitializer(Initializer):
    """He et al. 2015: U(+-sqrt(6 / fan_in)), or with ``uniform=False``
    N(0, 2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, seed

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        fan_in = self._fan_in if self._fan_in is not None \
            else _fan_in_out(var.shape)[0]
        if self._uniform:
            limit = math.sqrt(6.0 / fan_in)
            return self._append_uniform(var, block, -limit, limit)
        return self._append_normal(var, block, 0.0, math.sqrt(2.0 / fan_in))


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a 4-D deconv weight, written as
    a NumpyArray initializer."""

    def __call__(self, var, block=None):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = np.arange(shape[3]).reshape(1, shape[3])
        y = np.arange(shape[2]).reshape(shape[2], 1)
        kernel = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        weight = np.broadcast_to(kernel, tuple(shape)).astype("float32")
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    """The array's values, in an ``assign_value`` op."""

    _KEYS = {"float32": "fp32_values", "float64": "fp32_values",
             "int32": "int32_values", "int64": "int64_values",
             "bool": "bool_values"}

    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block=None):
        block = self._startup_block(block)
        self._declare(var, block)
        v = self._value
        key = self._KEYS.get(var.dtype, "fp32_values")
        cast = float if "fp" in key else int
        return block.append_op(
            type="assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(v.shape), "dtype": dtype_enum(var.dtype),
                   key: [cast(x) for x in v.flatten()]})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
