"""Program execution substrate of the port: op registry, block plans,
scope, executor and the static verifier (``analysis``).
``EOFException`` is Fluid's ``core.EOFException``: ``Executor.run`` raises
it when the started non-iterable DataLoader of the program has no batch
left."""

from .executor import (EOFException, Executor, global_scope, place_device,
                       scope_guard)
from .scope import Scope, scope_from_numpy, scope_to_numpy

__all__ = ["EOFException", "Executor", "global_scope", "place_device",
           "scope_guard", "Scope", "scope_from_numpy", "scope_to_numpy"]
