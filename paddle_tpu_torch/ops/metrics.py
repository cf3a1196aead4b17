"""Metric and comparison ops: top_k, accuracy, the six comparisons,
logical_and and isfinite.  Counterpart of ``paddle_tpu/ops/metrics.py``
(``top_k:13``, ``accuracy:38``, the comparisons ``:79-93``,
``logical_and:108``, ``isfinite:114``, which
the dynamic loss scaling of ``contrib.mixed_precision`` runs over every
gradient at once)."""

import torch

from ..core.registry import register_op


@register_op("top_k", inputs=("X", "K"), outputs=("Out", "Indices"),
             attrs={"k": 1}, optional_inputs=("K",))
def top_k(ctx, x, k_t, k=1):
    if k_t is not None:
        k = int(k_t.reshape(()).item())
    vals, idx = torch.topk(x, k, dim=-1)
    return vals, idx.long()


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


@register_op("logical_and", inputs=("X", "Y"), outputs=("Out",),
             grad_maker=None)
def logical_and(ctx, x, y):
    """Elementwise and (piecewise_decay's interval masks)."""
    return torch.logical_and(x, y)


@register_op("isfinite", inputs=("X",), outputs=("Out",), grad_maker=None,
             duplicable_inputs=("X",))
def isfinite(ctx, xs):
    """One flag [1]: every element of every input is finite."""
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for x in xs:
        ok = ok & torch.isfinite(x).all()
    return ok.reshape(1)
