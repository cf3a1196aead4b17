"""``gather_tree``, the beam backtrack of ``layers/rnn.py``'s
``BeamSearchDecoder``.  Counterpart of ``paddle_tpu/layers/extra.py``
(``gather_tree:419``, one of its ``_simple`` one-op layers)."""

from ..layer_helper import LayerHelper

__all__ = ["gather_tree"]


def gather_tree(ids, parents, name=None):
    """ids and parents [T, B, K] -> the backtracked sequences [T, B, K]."""
    helper = LayerHelper("gather_tree", name=name)
    out = helper.create_variable_for_type_inference(ids.dtype)
    helper.append_op(type="gather_tree",
                     inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]}, attrs={})
    return out
