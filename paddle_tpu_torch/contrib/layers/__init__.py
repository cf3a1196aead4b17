"""contrib.layers: the composite ``basic_gru`` / ``basic_lstm`` RNN API.
Counterpart of ``paddle_tpu/contrib/layers/__init__.py``, of which the
port carries ``rnn_impl``; the fused layer wrappers (``nn.py``) and
``ctr_metric_bundle`` (``metric_op.py``) are not ported."""

from . import rnn_impl
from .rnn_impl import *  # noqa: F401,F403

__all__ = list(rnn_impl.__all__)
