"""Op lowerings of the port; importing the package registers them all."""

from . import (activations, beam_search, control_flow,  # noqa: F401
               creation, loss, manip, math, metrics, nn, optimizer_ops, rnn,
               sequence)
