"""Loss ops: softmax_with_cross_entropy and
sigmoid_cross_entropy_with_logits.  Counterpart of
``paddle_tpu/ops/loss.py`` (``softmax_with_cross_entropy:68``,
``sigmoid_cross_entropy_with_logits:134``); their gradients are the
synthesized vjp replays."""

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


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             outputs=("Out",),
             attrs={"ignore_index": -100, "normalize": False},
             no_grad_inputs=("Label",))
def sigmoid_cross_entropy_with_logits(ctx, x, label, ignore_index=-100,
                                      normalize=False):
    """max(x, 0) - x label + log(1 + exp(-|x|)) per element, 0 where the
    label is ``ignore_index``; ``normalize`` divides by the count of the
    others (at least 1), as the reference."""
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if normalize:
        loss = loss / torch.clamp_min(mask.to(loss.dtype).sum(), 1.0)
    return loss
