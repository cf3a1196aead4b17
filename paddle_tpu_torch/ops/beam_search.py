"""Beam-search decode ops: ``beam_search``, ``beam_search_decode`` and
``gather_tree``.

Counterpart of ``paddle_tpu/ops/beam_search.py`` (``beam_search:28``,
``beam_search_decode:86``) and of ``paddle_tpu/ops/misc2.py``
(``gather_tree:122``), plain torch as the reference's are jnp:
the best K of the flattened [B, K * V] candidates (ties to the lower
index, as ``lax.top_k`` breaks them), then a gather walk
back along the parent pointers.  The reference's dense layout is kept: a
fixed [batch, beam] state, a pruned or finished beam carried by a masked
(-1e9) score instead of the LoD-ragged lists of Fluid's ops.

Protocol: the caller seeds pre_scores with [0, -1e9, ..., -1e9] per batch
row, so step 0 expands beam 0 only (all beams start the same); each step
calls ``beam_search`` with the accumulated per-beam scores of the next
token, writes the selected ids and parents into tensor arrays, and
``beam_search_decode`` backtracks the arrays into sequences.
"""

import torch

from ..core.registry import register_op

_NEG_INF = -1e9


def _beam_search_infer(op, block):
    """selected_ids / parent_idx int64 and selected_scores in the scores'
    dtype, each [B, K] with B the scores' first dim."""
    sv = block._find_var_recursive(op.input("scores")[0])
    if sv is None or sv.shape is None:
        return
    k = int(op.attrs.get("beam_size", 4))
    for slot, dt in (("selected_ids", "int64"), ("selected_scores", None),
                     ("parent_idx", "int64")):
        ov = block._find_var_recursive(op.output(slot)[0])
        if ov is not None:
            ov.shape = (sv.shape[0], k)
            if ov.dtype is None:
                ov.dtype = dt or sv.dtype


def top_k_lower_index(flat, k):
    """The ``k`` largest of each row of ``flat`` [B, N], best first, equal
    values to the lower index as ``lax.top_k`` breaks ties (``torch.topk``
    leaves their order open).  One ``topk`` over distinct int64 keys: the
    value's order-preserving 32 bits (-0.0 read as 0.0) above the index's
    complement; f64, or N past 2^32, by a stable sort."""
    if flat.dtype == torch.float64 or flat.shape[1] >= 1 << 32:
        vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    bits = (flat.float() + 0.0).view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    low = 0xFFFFFFFF - torch.arange(flat.shape[1], dtype=torch.int64,
                                    device=flat.device)
    top = torch.topk((ordered << 32) | low, k, dim=1).values
    idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return torch.gather(flat, 1, idx), idx


@register_op("beam_search",
             inputs=("pre_ids", "pre_scores", "ids", "scores"),
             outputs=("selected_ids", "selected_scores", "parent_idx"),
             attrs={"beam_size": 4, "end_id": 1, "level": 0,
                    "is_accumulated": True},
             optional_inputs=("ids",), grad_maker=None,
             infer_shape=_beam_search_infer)
def beam_search(ctx, pre_ids, pre_scores, ids, scores, beam_size=4,
                end_id=1, level=0, is_accumulated=True):
    """One expansion step.  pre_ids [B, K]: each beam's last token;
    pre_scores [B, K]: its accumulated log-prob; scores [B, K, V]: the
    next token's log-probs, already added to pre_scores when
    ``is_accumulated``.  A finished beam (last token ``end_id``) offers
    only ``end_id`` at its own score.  -> (selected_ids, selected_scores,
    parent_idx), each [B, K], best first."""
    b, k, v = scores.shape
    if not is_accumulated:
        scores = torch.log(torch.clamp_min(scores, 1e-20)) \
            + pre_scores.unsqueeze(-1)
    only_end = torch.full((b, k, v), _NEG_INF, dtype=scores.dtype,
                          device=scores.device)
    only_end[..., end_id] = pre_scores
    cand = torch.where((pre_ids == end_id).unsqueeze(-1), only_end, scores)
    sel_scores, flat = top_k_lower_index(cand.reshape(b, k * v), beam_size)
    return ((flat % v).to(pre_ids.dtype), sel_scores,
            torch.div(flat, v, rounding_mode="floor").to(pre_ids.dtype))


@register_op("beam_search_decode", inputs=("Ids", "ParentIdx", "Scores"),
             outputs=("SentenceIds", "SentenceScores"),
             attrs={"beam_size": 4, "end_id": 1},
             optional_inputs=("Scores",), grad_maker=None,
             infer_shape=lambda op, block: None)
def beam_search_decode(ctx, ids, parents, scores, beam_size=4, end_id=1):
    """Backtrack the tensor arrays Ids and ParentIdx (one [B, K] entry a
    step) into SentenceIds [B, K, T], each beam's tokens from the first
    step, ``end_id`` after its first ``end_id``; SentenceScores is Scores
    (the final accumulated log-probs, zeros without them)."""
    b, k = ids[0].shape
    rows = torch.arange(b, device=ids[0].device).unsqueeze(1)
    beam = torch.arange(k, device=ids[0].device).unsqueeze(0).expand(b, k)
    seq = []
    for t in range(len(ids) - 1, -1, -1):
        seq.append(ids[t][rows, beam])
        beam = parents[t][rows, beam].long()
    sent = torch.stack(seq[::-1], dim=-1)
    if scores is None:
        scores = torch.zeros((b, k), dtype=torch.float32,
                             device=sent.device)
    hit = torch.cumsum((sent == end_id).to(torch.int32), dim=-1)
    return torch.where(hit > 1, torch.full_like(sent, end_id), sent), scores


@register_op("gather_tree", inputs=("Ids", "Parents"), outputs=("Out",),
             grad_maker=None)
def gather_tree(ctx, ids, parents):
    """Backtrack parent pointers: ids and parents [T, B, K] -> the full
    sequence ending in each beam slot of the last step, [T, B, K]."""
    n_steps, b, k = ids.shape
    beams = torch.arange(k, device=ids.device).unsqueeze(0).expand(b, k)
    out = []
    for t in range(n_steps - 1, -1, -1):
        out.append(torch.gather(ids[t], 1, beams))
        beams = torch.gather(parents[t], 1, beams).long()
    return torch.stack(out[::-1])
