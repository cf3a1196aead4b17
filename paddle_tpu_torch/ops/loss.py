"""Loss op: softmax_with_cross_entropy.  Counterpart of
``paddle_tpu/ops/loss.py`` (``softmax_with_cross_entropy:68``); its
gradient is the synthesized vjp replay."""

import torch

from ..core.registry import register_op


def _take_label(logp, label, axis):
    """logp at integer labels along ``axis``; labels clipped into range so
    ignored entries gather safely (their loss is masked to zero)."""
    lab = label
    want = tuple(logp.shape[:axis]) + (1,) + tuple(logp.shape[axis + 1:])
    if not (tuple(lab.shape) == want
            or (lab.dim() == logp.dim() and lab.shape[axis] == 1)):
        lab = lab.unsqueeze(axis)
    safe = lab.long().clamp(0, logp.shape[axis] - 1)
    return torch.gather(logp, axis, safe), lab


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"),
             attrs={"soft_label": False, "ignore_index": -100,
                    "numeric_stable_mode": True, "axis": -1},
             no_grad_inputs=("Label",))
def softmax_with_cross_entropy(ctx, logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               axis=-1):
    """Loss in f32 whatever the logits' dtype, as the reference; the
    Softmax output is not differentiated through."""
    ax = axis if axis >= 0 else logits.dim() + axis
    logp = torch.log_softmax(logits.float(), dim=ax)
    softmax = logp.exp().detach()
    if soft_label:
        return softmax, -(label * logp).sum(dim=ax, keepdim=True)
    picked, lab = _take_label(logp, label, ax)
    loss = torch.where(lab == ignore_index, torch.zeros_like(picked),
                       -picked)
    return softmax, loss
