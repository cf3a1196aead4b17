"""Fluid's deprecated Evaluators (evaluator.py: ChunkEvaluator:127,
EditDistance:218, DetectionMAP:299).

Counterpart of ``paddle_tpu/evaluator.py``, whose Evaluators build the
``chunk_eval``, ``edit_distance`` and ``detection_map`` ops.  The port has
none of these ops yet, so each Evaluator raises by name; they come with
the long tail of ops (ROADMAP A9).  ``fluid.metrics`` holds their
accumulators.
"""

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator:
    """Base: each subclass names the op it waits for."""

    _op = None

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "%s builds the %s op, which the port does not have yet: it "
            "comes with the long tail of ops (ROADMAP A9); fluid.metrics.%s "
            "accumulates fetched values meanwhile"
            % (type(self).__name__, self._op, type(self).__name__))


class ChunkEvaluator(Evaluator):
    _op = "chunk_eval"


class EditDistance(Evaluator):
    _op = "edit_distance"


class DetectionMAP(Evaluator):
    _op = "detection_map"
