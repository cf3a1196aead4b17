"""Metric ops: top_k and accuracy.  Counterpart of
``paddle_tpu/ops/metrics.py`` (``top_k:13``, ``accuracy:38``)."""

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
