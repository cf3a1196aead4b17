"""Worker liveness for the port's parameter-server and serving-fleet
layers.

Counterpart of ``HeartBeatMonitor`` in ``paddle_tpu/distributed/ps.py``
(the rest of that module, the parameter server itself, is not ported).
The serving fleet (``serving/fleet.py``) runs one on its coordinator over
the replicas' ``__fhb__`` heartbeats.
"""

import logging
import threading
import time

from ..core import telemetry as _tm

__all__ = ["HeartBeatMonitor"]


class HeartBeatMonitor:
    """Records each worker's last contact; ``check`` returns (and logs
    once) the workers silent for longer than ``timeout_s``, keeps the
    ``ps_dead_workers{ps=name}`` gauge current and counts each new miss
    in ``ps_heartbeat_miss_total{ps=name}``.  The monitor is a passive
    bookkeeper: its caller decides what a dead worker means.

    ``timeout_s=None`` reads ``FLAGS_worker_hb_timeout``.  Workers are
    seeded at construction + ``startup_grace_s`` (default: one extra
    timeout), so one that dies before its first heartbeat is caught, but
    a slow start is not taken for death."""

    def __init__(self, n_workers, timeout_s=None, name="ps",
                 startup_grace_s=None, worker_ids=None):
        if timeout_s is None:
            from .. import flags

            timeout_s = float(flags.flag("worker_hb_timeout") or 60.0)
        self._time = time.time
        if worker_ids is None:
            worker_ids = range(n_workers)
        worker_ids = [int(w) for w in worker_ids]
        self.n_workers = len(worker_ids)
        self.timeout_s = timeout_s
        self.startup_grace_s = (timeout_s if startup_grace_s is None
                                else startup_grace_s)
        self.name = name
        now = self._time()
        self._last_seen = {w: now + self.startup_grace_s
                           for w in worker_ids}
        self._warned = set()
        self._lock = threading.Lock()

    def update(self, worker_id):
        with self._lock:
            self._last_seen[int(worker_id)] = self._time()
            self._warned.discard(int(worker_id))

    def remove(self, worker_id):
        """The worker left cleanly: stop tracking it."""
        with self._lock:
            self._last_seen.pop(int(worker_id), None)
            self._warned.discard(int(worker_id))

    def check(self):
        """The ids of the workers silent past the timeout."""
        now = self._time()
        with self._lock:
            dead = [(w, now - t) for w, t in self._last_seen.items()
                    if now - t > self.timeout_s]
            fresh = [wt for wt in dead if wt[0] not in self._warned]
            self._warned.update(w for w, _ in fresh)
        _tm.set_gauge("ps_dead_workers", len(dead), ps=self.name)
        if fresh:
            _tm.inc("ps_heartbeat_miss_total", len(fresh), ps=self.name)
        for w, silent in fresh:
            logging.warning("[%s] worker %d silent for %.0fs",
                            self.name, w, silent)
        return [w for w, _ in dead]
