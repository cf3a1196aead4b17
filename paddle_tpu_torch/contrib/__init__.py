"""contrib: the mixed-precision decorator, the composite RNN layers and
the decoders.  Counterpart of ``paddle_tpu/contrib/__init__.py``, of
which the port carries ``mixed_precision``, ``layers`` (``rnn_impl``)
and ``decoder``."""

from . import decoder, layers, mixed_precision  # noqa: F401

__all__ = ["decoder", "layers", "mixed_precision"]
