"""contrib: the mixed-precision decorator.  Counterpart of
``paddle_tpu/contrib/__init__.py``, of which the port carries
``mixed_precision``."""

from . import mixed_precision  # noqa: F401

__all__ = ["mixed_precision"]
