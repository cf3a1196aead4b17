"""Beam-search layers.  Counterpart of ``paddle_tpu/layers/rnn.py``
(``beam_search:18``, ``beam_search_decode:46``) over the dense
[batch, beam] state of ``ops/beam_search.py``; the GRU and LSTM units are
not ported."""

from ..layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One beam expansion step -> (selected_ids, selected_scores[,
    parent_idx]), each [B, K]."""
    helper = LayerHelper("beam_search", name=name)
    selected_ids = helper.create_variable_for_type_inference(
        dtype=pre_ids.dtype)
    selected_scores = helper.create_variable_for_type_inference(
        dtype=scores.dtype)
    parent_idx = helper.create_variable_for_type_inference(
        dtype=pre_ids.dtype)
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(type="beam_search", inputs=inputs,
                     outputs={"selected_ids": [selected_ids],
                              "selected_scores": [selected_scores],
                              "parent_idx": [parent_idx]},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "level": level,
                            "is_accumulated": is_accumulated})
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, parent_idx, scores=None, beam_size=4, end_id=1,
                       name=None):
    """Backtrack the tensor arrays of ids and parents into sequences ->
    (SentenceIds [B, K, T], SentenceScores [B, K])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sentence_ids = helper.create_variable_for_type_inference(dtype="int64")
    sentence_scores = helper.create_variable_for_type_inference(
        dtype="float32")
    inputs = {"Ids": [ids], "ParentIdx": [parent_idx]}
    if scores is not None:
        inputs["Scores"] = [scores]
    helper.append_op(type="beam_search_decode", inputs=inputs,
                     outputs={"SentenceIds": [sentence_ids],
                              "SentenceScores": [sentence_scores]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sentence_ids, sentence_scores
