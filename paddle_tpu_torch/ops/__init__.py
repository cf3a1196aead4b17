"""Op lowerings of the port; importing the package registers them all."""

from . import (activations, creation, loss, manip, math,  # noqa: F401
               metrics, nn, optimizer_ops)
