"""True-positive fixture for R7: unguarded / inconsistently-guarded shared state."""

import threading


class NoDiscipline:  # concurrency: shared scrapes read while workers write
    """Shared by marker, mutates + iterates its dict with no lock at all."""

    def __init__(self):
        self.volumes = {}

    def note(self, sid):
        self.volumes[sid] = self.volumes.get(sid, 0) + 1  # R7: rmw, no lock

    def top(self):
        return sorted(self.volumes.items())  # R7: iterate, no lock


class HalfGuarded:
    """Thread-spawning class guarding writes but not the reader."""

    def __init__(self):
        self._lock = threading.Lock()
        self.jobs = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        with self._lock:
            self.jobs.append(1)

    def close(self):
        self._thread.join()
        return list(self.jobs)  # R7: iterate without the lock other sites hold


_PENDING = {}


def _enqueue(key):
    _PENDING[key] = _PENDING.get(key, 0) + 1  # R7: rmw on a bare module global


def _drain():
    with _MOD_LOCK:
        return dict(_PENDING)


_MOD_LOCK = threading.Lock()
