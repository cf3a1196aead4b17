"""Unique name generation for variables/ops: the port's own copy of
``paddle_tpu/utils/unique_name.py`` (generator with prefix counters,
guard for scoped renaming), so programs built under the same guard get
the same names in both packages.
"""

import contextlib
import threading

__all__ = ["generate", "guard", "switch"]


class _NameGenerator:
    def __init__(self, prefix=""):
        self._prefix = prefix
        self._counters = {}
        self._lock = threading.Lock()

    def generate(self, key):
        with self._lock:
            idx = self._counters.get(key, 0)
            self._counters[key] = idx + 1
        return "%s%s_%d" % (self._prefix, key, idx)


# One shared default generator (uniqueness across ALL threads appending to
# the same program), with per-thread overrides: a thread that wants an
# isolated, reproducible name sequence (pserver/worker role threads standing
# in for the reference's separate processes) opts in via guard()/switch().
_default_generator = _NameGenerator()
_tls = threading.local()


def _gen():
    return getattr(_tls, "generator", None) or _default_generator


def generate(key):
    """Generate a unique name like ``fc_0.w_0`` for the given key."""
    return _gen().generate(key)


def switch(new_generator=None):
    old = getattr(_tls, "generator", None)
    _tls.generator = (new_generator if new_generator is not None
                      else _NameGenerator())
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = _NameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        # restore exactly: None means "no thread-local override" (shared
        # default generator), not a fresh generator
        _tls.generator = old
