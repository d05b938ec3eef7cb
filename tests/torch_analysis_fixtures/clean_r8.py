"""False-positive fixture for R8: blocking work outside the critical section."""

import os
import threading
import time


class CaptureThenBlock:
    """The guarded-sync/snapshot idiom: copy state under the lock, do the
    blocking IO/wait after releasing it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fh = None
        self.pending = {}

    def flush(self):
        with self._lock:
            batch = dict(self.pending)
            self.pending.clear()
        time.sleep(0)  # yield outside the lock: fine
        for item in batch.values():
            self._write(item)
        os.fsync(self._fh.fileno())  # after release: fine

    def _write(self, item):
        self._fh.write(item)

    def wait_for(self, event):
        with self._lock:
            armed = bool(self.pending)
        if armed:
            event.wait(1.0)  # outside the lock: fine
