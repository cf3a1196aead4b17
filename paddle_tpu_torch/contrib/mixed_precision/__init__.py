"""The bf16 AMP policy: ``decorate(optimizer)``.  Counterpart of
``paddle_tpu/contrib/mixed_precision/__init__.py``."""

from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists"]
