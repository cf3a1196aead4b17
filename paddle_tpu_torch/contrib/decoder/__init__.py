"""contrib.decoder: ``InitState``, ``StateCell``, ``TrainingDecoder`` and
``BeamSearchDecoder``.  Counterpart of
``paddle_tpu/contrib/decoder/__init__.py``."""

from .beam_search_decoder import (BeamSearchDecoder,  # noqa: F401
                                  InitState, StateCell, TrainingDecoder)

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]
