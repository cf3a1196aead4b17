"""``fluid.one_hot`` and ``fluid.embedding``, the v2 forms (Fluid's
input.py: one_hot:24, embedding:126).

Counterpart of ``paddle_tpu/input.py``: the ids carry no trailing [1] and
the output appends the new axis to the ids' shape (unlike
``layers.one_hot`` / ``layers.embedding``, whose v1 ops squeeze a trailing
[1]).
"""

from .layer_helper import LayerHelper

__all__ = ["one_hot", "embedding"]


def one_hot(input, depth, allow_out_of_range=False):
    """Out shape = ids.shape + [depth]."""
    from . import layers

    flat = layers.reshape(input, shape=[-1, 1])
    oh = layers.one_hot(flat, depth, allow_out_of_range=allow_out_of_range)
    out_shape = [d if d > 0 else -1 for d in (input.shape or [-1])]
    return layers.reshape(oh, shape=out_shape + [depth])


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """The ``lookup_table_v2`` op: out shape = ids.shape + [emb_dim]."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=param_attr, shape=size, dtype=dtype,
                                is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table_v2",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": pad})
    return out
