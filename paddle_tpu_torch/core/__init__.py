"""Program execution substrate of the port: op registry, block plans,
scope and executor."""

from .executor import Executor, global_scope, place_device, scope_guard
from .scope import Scope, scope_from_numpy, scope_to_numpy

__all__ = ["Executor", "global_scope", "place_device", "scope_guard",
           "Scope", "scope_from_numpy", "scope_to_numpy"]
