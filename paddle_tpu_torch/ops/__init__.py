"""Op lowerings of the port; importing the package registers them all."""

from . import activations, creation, manip, math, nn  # noqa: F401
