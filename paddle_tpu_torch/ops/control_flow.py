"""Tensor arrays: ``write_to_array`` at an index the step knows.

Counterpart of ``paddle_tpu/ops/control_flow.py`` (``write_to_array:115``,
its list form).  An array is a Python list in the step's env, made by its
first write, never stored in the scope (``lowering.analyze_block``); the
unrolled beam decoder writes one [B, K] entry a step and
``beam_search_decode`` reads the lists.  The executor runs eagerly, so the
index tensor always has a value: it is read on the host (on the card, a
wait for the work queued before it).  The reference's bounded form, for
an index that a data-dependent ``while`` carries, and the ``while`` and
``conditional_block`` ops themselves are not ported: building with them
raises (``layers/control_flow.py``).
"""

from ..core.registry import register_op


@register_op("write_to_array", inputs=("X", "I", "Array"), outputs=("Out",),
             optional_inputs=("Array",), grad_maker=None)
def write_to_array(ctx, x, i, array):
    """The array with ``x`` at index ``i``, grown with None up to it."""
    idx = int(i.reshape(-1)[0])
    arr = list(array) if array is not None else []
    while len(arr) <= idx:
        arr.append(None)
    arr[idx] = x
    return (arr,)  # tuple-wrapped: a bare list would read as one per slot
