"""What the fused optimizer kernels' groups share: the device table of
the fused Adam kernel's group (``csrc/fused_adam.cu``: one launch updates
every member in place, each CTA finding its member by binary search over
the table's block-count prefixes), and which bf16 copies of the new
params the plain versions return."""

import numpy as np
import torch

__all__ = ["PER_BLOCK", "group_table", "requested_copies"]

# elements a CTA updates (256 threads x 4)
PER_BLOCK = 1024

# keyed by the members' storage, which the in-place updates keep from
# step to step
_TABLES = {}


def group_table(rows, sizes, device, check):
    """(device int64 table, total blocks): ``rows`` of one pointer (or 0)
    per member, then the members' sizes, then the n + 1 block-count
    prefixes, as the kernels read them.  Built, after ``check()`` of the
    members, on a group's first step and cached."""
    key = tuple(tuple(r) for r in rows) + (tuple(sizes),)
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    check()
    blocks = [max(1, -(-s // PER_BLOCK)) for s in sizes]
    starts = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int64)
    flat = np.concatenate([np.asarray(list(rows) + [list(sizes)],
                                      np.int64).reshape(-1), starts])
    if len(_TABLES) > 64:  # groups of programs no longer run
        _TABLES.clear()
    _TABLES[key] = hit = (torch.from_numpy(flat).to(device), int(starts[-1]))
    return hit


def requested_copies(copies, bf16_out):
    """The plain version's bf16 copies of the members ``bf16_out`` asks
    for (a list with a tensor or None per member, or True for all)."""
    if copies is None or bf16_out is True:
        return copies
    return [c if b is not None else None for c, b in zip(copies, bf16_out)]
