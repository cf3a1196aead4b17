"""Tensor creation: fill_constant, uniform_random, gaussian_random and
truncated_gaussian_random, the ops the startup program's initialisers
emit, fill_constant_batch_size_like, assign, assign_value and cast.
Counterpart of ``paddle_tpu/ops/creation.py`` (``fill_constant:18``,
``fill_constant_batch_size_like:59``, ``uniform_random:76``,
``gaussian_random:96``, ``truncated_gaussian_random:121``,
``assign:143``, ``assign_value:149``,
``cast:163``)."""

import math

import torch

from ..core.lowering import new_generator
from ..core.registry import register_op
from .common import attr_dtype


@register_op("fill_constant",
             inputs=("ShapeTensor", "ShapeTensorList", "ValueTensor"),
             outputs=("Out",),
             attrs={"shape": [], "value": 0.0, "dtype": 5,
                    "force_cpu": False, "str_value": ""},
             optional_inputs=("ShapeTensor", "ShapeTensorList",
                              "ValueTensor"),
             duplicable_inputs=("ShapeTensorList",))
def fill_constant(ctx, shape_tensor, shape_tensor_list, value_tensor,
                  shape=(), value=0.0, dtype=5, force_cpu=False,
                  str_value=""):
    if str_value not in ("", None):
        value = float(str_value)
    if value_tensor is not None:
        value = value_tensor.reshape(()).item()
    return torch.full(tuple(int(s) for s in shape), value,
                      dtype=attr_dtype(dtype), device=ctx.device)


@register_op("fill_constant_batch_size_like", inputs=("Input",),
             outputs=("Out",),
             attrs={"shape": [], "value": 0.0, "dtype": 5, "input_dim_idx": 0,
                    "output_dim_idx": 0, "force_cpu": False},
             grad_maker=None)
def fill_constant_batch_size_like(ctx, input, shape=(), value=0.0, dtype=5,
                                  input_dim_idx=0, output_dim_idx=0,
                                  force_cpu=False):
    """A constant of ``shape`` whose ``output_dim_idx`` dim is the input's
    ``input_dim_idx`` dim (the batch the beam decoder seeds its state
    with)."""
    out_shape = [int(s) for s in shape]
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    return torch.full(tuple(out_shape), value, dtype=attr_dtype(dtype),
                      device=ctx.device)


@register_op("uniform_random", inputs=("ShapeTensor", "ShapeTensorList"),
             outputs=("Out",),
             attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": 5, "diag_num": 0, "diag_step": 0,
                    "diag_val": 1.0},
             optional_inputs=("ShapeTensor", "ShapeTensorList"),
             duplicable_inputs=("ShapeTensorList",), n_rng=1)
def uniform_random(ctx, shape_tensor, shape_tensor_list, shape=(), min=-1.0,
                   max=1.0, seed=0, dtype=5, diag_num=0, diag_step=0,
                   diag_val=1.0):
    """U[min, max) drawn on the op's device from a torch.Generator: the
    op's own seed when set, else the executor's per-op generator (program
    seed, step, op index).  The values differ from the reference's JAX
    draw; the distribution is the same."""
    out = torch.empty(tuple(int(s) for s in shape), dtype=attr_dtype(dtype),
                      device=ctx.device)
    if ctx.abstract:
        return out
    gen = new_generator(ctx.device, seed) if seed else ctx.generator
    return out.uniform_(min, max, generator=gen)


@register_op("gaussian_random", inputs=("ShapeTensor", "ShapeTensorList"),
             outputs=("Out",),
             attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                    "dtype": 5},
             optional_inputs=("ShapeTensor", "ShapeTensorList"),
             duplicable_inputs=("ShapeTensorList",), grad_maker=None,
             n_rng=1)
def gaussian_random(ctx, shape_tensor, shape_tensor_list, shape=(),
                    mean=0.0, std=1.0, seed=0, dtype=5):
    """N(mean, std^2) drawn on the op's device from a torch.Generator, as
    ``uniform_random`` draws: the op's own seed when set, else the
    executor's per-op generator.  The values differ from the reference's
    JAX draw; the distribution is the same."""
    out = torch.empty(tuple(int(s) for s in shape), dtype=attr_dtype(dtype),
                      device=ctx.device)
    if ctx.abstract:
        return out
    gen = new_generator(ctx.device, seed) if seed else ctx.generator
    return out.normal_(mean, std, generator=gen)


@register_op("truncated_gaussian_random", outputs=("Out",),
             attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                    "dtype": 5},
             grad_maker=None, n_rng=1)
def truncated_gaussian_random(ctx, shape=(), mean=0.0, std=1.0, seed=0,
                              dtype=5):
    """mean + std x, x a standard normal truncated to [-2, 2] (the
    reference's ``jax.random.truncated_normal(key, -2, 2)``), drawn by the
    inverse CDF of a uniform over [Phi(-2), Phi(2)]; the generator as
    ``uniform_random``'s.  The values differ from the reference's JAX
    draw; the distribution is the same."""
    out = torch.empty(tuple(int(s) for s in shape), dtype=attr_dtype(dtype),
                      device=ctx.device)
    if ctx.abstract:
        return out
    gen = new_generator(ctx.device, seed) if seed else ctx.generator
    edge = math.erf(2.0 / math.sqrt(2.0))    # 2 Phi(2) - 1
    x = out.uniform_(-edge, edge, generator=gen).erfinv_()
    return x.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std).add_(mean)


@register_op("assign", inputs=("X",), outputs=("Out",))
def assign(ctx, x):
    """The identity (what ``delete_dropout_pass`` leaves of an inference
    dropout), but a copy where Out is persistable (Lookahead's startup
    ``slow = param``): the two then outlive the step, and an optimizer
    updates the first in place."""
    op = ctx.op
    var = op.block._find_var_recursive(op.output("Out")[0]) \
        if op is not None else None
    if var is not None and var.persistable and not ctx.abstract:
        return x.clone()
    return x


@register_op("assign_value", outputs=("Out",),
             attrs={"shape": [], "dtype": 5, "fp32_values": [],
                    "int32_values": [], "int64_values": [],
                    "bool_values": []},
             grad_maker=None)
def assign_value(ctx, shape=(), dtype=5, fp32_values=(), int32_values=(),
                 int64_values=(), bool_values=()):
    """The constant the attrs carry (a numpy array the program was built
    with), in ``dtype`` and ``shape``.  The values are an attr list, so
    every run turns them into a tensor on the host and copies it over."""
    dt = attr_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if ctx.abstract:
        return torch.empty(shape, dtype=dt, device=ctx.device)
    vals = fp32_values or int32_values or int64_values or bool_values
    return torch.tensor(vals, dtype=dt).reshape(shape).to(ctx.device)


@register_op("cast", inputs=("X",), outputs=("Out",),
             attrs={"in_dtype": 5, "out_dtype": 5})
def cast(ctx, x, in_dtype=5, out_dtype=5):
    """x in ``out_dtype`` (round to nearest even into bf16); its grad is
    the synthesized replay, the output grad cast back to x's dtype."""
    return x.to(attr_dtype(out_dtype))
