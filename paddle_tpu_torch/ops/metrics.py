"""Metric and comparison ops: top_k, accuracy, arg_max and arg_min, the
six comparisons, the four logical ops and isfinite.  Counterpart of
``paddle_tpu/ops/metrics.py`` (``top_k:13``, ``accuracy:38``,
``arg_max:51``, ``arg_min:61``, the comparisons ``:79-93``, the logical
ops of ``_register_logical:96-111``, ``isfinite:114``, which
the dynamic loss scaling of ``contrib.mixed_precision`` runs over every
gradient at once)."""

import torch

from ..core.registry import register_op
from .beam_search import top_k_lower_index


@register_op("top_k", inputs=("X", "K"), outputs=("Out", "Indices"),
             attrs={"k": 1}, optional_inputs=("K",))
def top_k(ctx, x, k_t, k=1):
    """The ``k`` largest along the last dim, equal values to the lower
    index first and -0.0 below 0.0, as ``lax.top_k`` orders them."""
    if k_t is not None:
        k = int(k_t.reshape(()).item())
    flat = x.reshape(-1, x.shape[-1])
    # the order from the values alone; the gather keeps them differentiable
    _vals, idx = top_k_lower_index(flat.detach(), k, signed_zero=True)
    vals = torch.gather(flat, 1, idx)
    lead = tuple(x.shape[:-1])
    return vals.reshape(lead + (k,)), idx.long().reshape(lead + (k,))


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"), grad_maker=None)
def accuracy(ctx, out, indices, label):
    n = indices.shape[0]
    correct = (indices == label.reshape(n, 1)).any(dim=1).sum()
    return ((correct.float() / n).reshape(1),
            correct.to(torch.int32).reshape(1),
            torch.full((1,), n, dtype=torch.int32, device=indices.device))


_COMPARE = {"equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
            "less_equal": torch.le, "greater_than": torch.gt,
            "greater_equal": torch.ge}


def _compare(fn):
    def lower(ctx, x, y, axis=-1, force_cpu=False):
        return fn(x, y)

    return lower


for _name, _fn in _COMPARE.items():
    register_op(_name, inputs=("X", "Y"), outputs=("Out",),
                attrs={"axis": -1, "force_cpu": False},
                grad_maker=None)(_compare(_fn))


def _logical(fn, binary=True):
    if binary:
        def lower(ctx, x, y):
            return fn(x, y)
    else:
        def lower(ctx, x):
            return fn(x)
    return lower


# logical_and: piecewise_decay's interval masks; the others the predicates
# of Switch (logical_not) and of the loops
for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    register_op(_name, inputs=("X", "Y"), outputs=("Out",),
                grad_maker=None)(_logical(_fn))
register_op("logical_not", inputs=("X",), outputs=("Out",),
            grad_maker=None)(_logical(torch.logical_not, binary=False))


def _arg(fn):
    def lower(ctx, x, axis=-1, keepdims=False, dtype=3, flatten=False):
        if flatten:
            x, axis = x.reshape(-1), 0
        return fn(x, dim=axis, keepdim=keepdims).long()

    return lower


for _name, _fn in (("arg_max", torch.argmax), ("arg_min", torch.argmin)):
    register_op(_name, inputs=("X",), outputs=("Out",),
                attrs={"axis": -1, "keepdims": False, "dtype": 3,
                       "flatten": False}, grad_maker=None)(_arg(_fn))


@register_op("isfinite", inputs=("X",), outputs=("Out",), grad_maker=None,
             duplicable_inputs=("X",))
def isfinite(ctx, xs):
    """One flag [1]: every element of every input is finite."""
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for x in xs:
        ok = ok & torch.isfinite(x).all()
    return ok.reshape(1)
