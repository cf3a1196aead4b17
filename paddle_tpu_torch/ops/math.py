"""Dense math ops: mul, matmul, the elementwise family, scale, sum,
mean, reduce_sum, clip, clip_by_norm, squared_l2_norm, increment, the
explicit grads of mul, elementwise_add
and reduce_sum, and the two ops the predictor's passes emit, fc and
fused_elemwise_activation.

Counterpart of ``paddle_tpu/ops/math.py`` (``_amp_dot:25``, ``mul:48``,
``matmul:66``, the elementwise ops ``:120-148``, ``scale:151``,
``sum:163``, ``mean:172``, ``reduce_sum`` of ``_register_reduce:183``,
``clip:212``, ``clip_by_norm:220``, ``squared_l2_norm:226``,
``increment:231``)
and of ``paddle_tpu/ops/coverage_tail.py``
(``fc:92``, ``fused_elemwise_activation:469``).  The products are plain
``torch.matmul`` calls (cuBLAS on the card, in full f32: TF32 is off), as
the reference leaves them to XLA.  The reference differentiates mul and
elementwise_add by replaying them under ``jax.vjp``, where XLA drops the
replayed product; an eager replay would pay it, so the port's
``mul_grad`` and ``elementwise_add_grad`` are written out.

Under the bf16 AMP policy (``LowerCtx.amp_bf16``) a product takes bf16
operands and gives a bf16 result (f32 sums), so the activations after
the first product stay bf16; an elementwise op over a bf16 / f32 pair
computes in bf16.  The explicit grads give what the reference's vjp
gives: the output grad cast to the output's dtype first, each input's
grad in that input's dtype.
"""

import torch

from ..core.registry import register_grad_lowering, register_op, wants_grad
from .common import bcast_y

_BF16 = torch.bfloat16
_FLOAT = (torch.float32, torch.bfloat16)


def _amp(ctx, x):
    """Whether a product over ``x`` takes bf16 operands (the reference's
    ``_amp_dot``: the policy is on and x is f32 or bf16)."""
    return x.dtype in _FLOAT and ctx.amp_bf16()


def _amp_pair(ctx, x, y):
    """x, y of an elementwise op: a bf16 / f32 pair under the policy is
    computed in bf16, as the reference's."""
    if {x.dtype, y.dtype} == set(_FLOAT) and ctx.amp_bf16():
        return x.to(_BF16), y.to(_BF16)
    return x, y


def _flatten2d(x, num_col_dims):
    lead = 1
    for d in x.shape[:num_col_dims]:
        lead *= d
    return x.reshape(lead, -1)


@register_op("mul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1,
                    "scale_x": 1.0, "scale_y": [1.0], "scale_out": 1.0,
                    "force_fp32_output": False})
def mul(ctx, x, y, x_num_col_dims=1, y_num_col_dims=1, **_):
    """Fluid's flatten-to-2D product (mul_op.cc:37); the output keeps the
    unflattened leading dims of x and trailing dims of y."""
    if _amp(ctx, x):
        x, y = x.to(_BF16), y.to(_BF16)
    out = torch.matmul(_flatten2d(x, x_num_col_dims),
                       _flatten2d(y, y_num_col_dims))
    return out.reshape(tuple(x.shape[:x_num_col_dims])
                       + tuple(y.shape[y_num_col_dims:]))


@register_op("matmul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"transpose_X": False, "transpose_Y": False,
                    "alpha": 1.0, "head_number": 1})
def matmul(ctx, x, y, transpose_X=False, transpose_Y=False, alpha=1.0,
           head_number=1):
    if transpose_X and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_Y and y.dim() > 1:
        y = y.transpose(-1, -2)
    if _amp(ctx, x):
        x, y = x.to(_BF16), y.to(_BF16)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        # alpha in the product's dtype, as the reference's
        # jnp.asarray(alpha, dtype=out.dtype)
        out = out * _bf16_scalar(alpha, out)
    return out


def _elementwise(fn):
    def lower(ctx, x, y, axis=-1):
        x, y = _amp_pair(ctx, x, y)
        return fn(x, bcast_y(x, y, axis))

    return lower


_ELEMENTWISE = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.true_divide, "max": torch.maximum, "min": torch.minimum,
    "pow": torch.pow, "mod": torch.remainder,
    "floordiv": torch.floor_divide,
}

for _name, _fn in _ELEMENTWISE.items():
    register_op("elementwise_" + _name, inputs=("X", "Y"), outputs=("Out",),
                attrs={"axis": -1})(_elementwise(_fn))


def _bf16_scalar(v, x):
    """A Python scalar in bf16 where x is bf16, as the reference's
    jnp.asarray(v, dtype=x.dtype): 1e4 times a bf16 one is 9984, not a
    rounding of 10000 (an f32 x takes the number as it is)."""
    return torch.tensor(v, dtype=_BF16) if x.dtype == _BF16 else v


@register_op("scale", inputs=("X", "ScaleTensor"), outputs=("Out",),
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True},
             optional_inputs=("ScaleTensor",))
def scale(ctx, x, scale_tensor, scale=1.0, bias=0.0, bias_after_scale=True):
    s = scale_tensor.reshape(()) if scale_tensor is not None \
        else _bf16_scalar(scale, x)
    b = _bf16_scalar(bias, x)
    if bias_after_scale:
        return x * s + b
    return (x + b) * s


@register_op("sum", inputs=("X",), outputs=("Out",),
             duplicable_inputs=("X",))
def sum_op(ctx, xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ctx, x):
    return x.mean().reshape(1)


def _reduce_dims(x, dim, reduce_all):
    """The dims a reduce op sums over: all of them under ``reduce_all`` or
    an empty ``dim``, else ``dim`` with negatives counted from the end."""
    if reduce_all or dim is None or len(dim) == 0:
        return tuple(range(x.dim()))
    return tuple(d if d >= 0 else d + x.dim() for d in dim)


@register_op("reduce_sum", inputs=("X",), outputs=("Out",),
             attrs={"dim": [0], "keep_dim": False, "reduce_all": False})
def reduce_sum(ctx, x, dim=(0,), keep_dim=False, reduce_all=False):
    """Sum over ``dim`` (or every dim), the reduced dims kept as 1 under
    ``keep_dim``; a full reduction without it is [1]."""
    out = x.sum(dim=_reduce_dims(x, dim, reduce_all), keepdim=keep_dim)
    return out.reshape(1) if out.dim() == 0 else out


@register_op("reduce_mean", inputs=("X",), outputs=("Out",),
             attrs={"dim": [0], "keep_dim": False, "reduce_all": False})
def reduce_mean(ctx, x, dim=(0,), keep_dim=False, reduce_all=False):
    """Mean over ``dim`` (or every dim), as ``reduce_sum``."""
    out = x.mean(dim=_reduce_dims(x, dim, reduce_all), keepdim=keep_dim)
    return out.reshape(1) if out.dim() == 0 else out


@register_grad_lowering("reduce_sum")
def reduce_sum_grad(ctx, x, out, dout, dim=(0,), keep_dim=False,
                    reduce_all=False):
    """dX: the output grad broadcast back over the summed dims."""
    if dout is None:
        return (None,)
    axes = _reduce_dims(x, dim, reduce_all)
    kept = [1 if i in axes else n for i, n in enumerate(x.shape)]
    g = dout.to(out.dtype).reshape(kept).expand(x.shape)
    return (g.to(x.dtype).contiguous(),)


@register_op("clip", inputs=("X", "Min", "Max"), outputs=("Out",),
             attrs={"min": 0.0, "max": 0.0}, optional_inputs=("Min", "Max"))
def clip(ctx, x, min_t, max_t, min=0.0, max=0.0):
    """x clamped to [min, max], the bounds from the tensors where given
    (GradientClipByValue)."""
    lo = min_t.reshape(()) if min_t is not None else min
    hi = max_t.reshape(()) if max_t is not None else max
    return torch.clamp(x, lo, hi)


@register_op("clip_by_norm", inputs=("X",), outputs=("Out",),
             attrs={"max_norm": 1.0})
def clip_by_norm(ctx, x, max_norm=1.0):
    """x scaled by min(max_norm / max(||x||, 1e-12), 1) (GradientClipByNorm),
    the scale a device scalar: no sync."""
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return x * scale


@register_op("squared_l2_norm", inputs=("X",), outputs=("Out",))
def squared_l2_norm(ctx, x):
    """sum(x^2) as [1] (GradientClipByGlobalNorm's per-gradient term)."""
    return torch.sum(x * x).reshape(1)


@register_op("increment", inputs=("X",), outputs=("Out",),
             attrs={"step": 1.0}, grad_maker=None)
def increment(ctx, x, step=1.0):
    """x + step in x's dtype (a counter: the LR schedule's step, the
    beam decoder's array index)."""
    return x + (step if x.is_floating_point() else int(step))


@register_grad_lowering("mul")
def mul_grad(ctx, x, y, out, dout, x_num_col_dims=1, y_num_col_dims=1,
             **_):
    """dX = dOut . Y^T and dY = X^T . dOut over the flattened 2-D views,
    reshaped back; only the gradients the op writes are computed.  Under
    AMP the products take bf16 operands, as the forward's."""
    xd, yd = x.dtype, y.dtype
    if _amp(ctx, x):
        x, y = x.to(_BF16), y.to(_BF16)
    x2 = _flatten2d(x, x_num_col_dims)
    y2 = _flatten2d(y, y_num_col_dims)
    d2 = dout.to(out.dtype).reshape(x2.shape[0], y2.shape[1])
    dx = torch.matmul(d2, y2.t()).reshape(x.shape).to(xd) \
        if wants_grad(ctx, "X") else None
    dy = torch.matmul(x2.t(), d2).reshape(y.shape).to(yd) \
        if wants_grad(ctx, "Y") else None
    return dx, dy


def _unbroadcast(g, shape):
    """Sum ``g`` over the dims a broadcast added to a tensor of
    ``shape``, back to ``shape``."""
    if tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, n in enumerate(shape)
                                if n == 1 and g.shape[lead + i] != 1]
    return g.sum(dim=dims, keepdim=True).reshape(shape) if dims \
        else g.reshape(shape)


@register_grad_lowering("elementwise_add")
def elementwise_add_grad(ctx, x, y, out, dout, axis=-1):
    """dX and dY: the output grad in the output's dtype, summed over the
    dims the broadcast added (in f32, rounded once: the reference's
    XLA:CPU sums a bf16 cotangent in bf16), each in its input's dtype."""
    dout = dout.to(out.dtype)
    dx = _unbroadcast(dout, x.shape).to(x.dtype) \
        if wants_grad(ctx, "X") else None
    dy = None
    if wants_grad(ctx, "Y"):
        yb = bcast_y(x, y, axis)  # y as the forward broadcast it
        dy = _unbroadcast(dout, yb.shape).reshape(y.shape).to(y.dtype)
    return dx, dy


# -- ops of the inference passes (ir.py) ------------------------------------


@register_op("fc", inputs=("Input", "W", "Bias"), outputs=("Out",),
             attrs={"in_num_col_dims": 1, "activation_type": "",
                    "use_mkldnn": False, "padding_weights": False},
             optional_inputs=("Bias",))
def fc(ctx, x, w, bias=None, in_num_col_dims=1, activation_type="", **_):
    """What ``fc_fuse_pass`` makes of mul + elementwise_add (+ relu): x
    flattened to 2-D at ``in_num_col_dims``, times w, plus the bias row.
    The reference's fc does not read the AMP policy (only the inference
    passes emit it): it computes in the promoted dtype of x and w, as
    ``x @ w`` promotes in jnp, and so does this one."""
    dt = torch.promote_types(x.dtype, w.dtype)
    out = torch.matmul(_flatten2d(x.to(dt), in_num_col_dims), w.to(dt))
    if bias is not None:
        out = out + bias.reshape(1, -1)
    if activation_type == "relu":
        out = torch.relu(out)
    return out.reshape(tuple(x.shape[:in_num_col_dims]) + (w.shape[-1],))


_FUSED_ACTS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid, "identity": lambda v: v,
               "": lambda v: v}


@register_op("fused_elemwise_activation", inputs=("X", "Y"),
             outputs=("Out", "IntermediateOut"),
             attrs={"functor_list": [], "axis": -1, "scale": 1.0,
                    "save_intermediate_out": False})
def fused_elemwise_activation(ctx, x, y, functor_list=(), axis=-1,
                              scale=1.0, save_intermediate_out=False):
    """f1(f2(x, y)) over {elementwise_add, elementwise_mul} x {relu, tanh,
    sigmoid, scale, identity}, as the reference composes it; -> (Out, the
    inner result)."""

    def apply_one(name, a, b=None):
        if name == "elementwise_add":
            return a + bcast_y(a, b, axis)
        if name == "elementwise_mul":
            return a * bcast_y(a, b, axis)
        if name == "scale":
            return a * scale
        return _FUSED_ACTS[name](a)

    f1, f2 = (list(functor_list) + ["identity", "identity"])[:2]
    if f2.startswith("elementwise_"):
        inter = apply_one(f2, x, y)
        return apply_one(f1, inter), inter
    inter = apply_one(f2, y)
    return apply_one(f1, x, inter), inter
