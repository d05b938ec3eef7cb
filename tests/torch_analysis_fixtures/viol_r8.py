"""True-positive fixture for R8: blocking calls inside lock critical sections."""

import os
import threading
import time


class BlocksUnderLock:
    def __init__(self):
        self._lock = threading.Lock()
        self._fh = None
        self.pending = {}

    def flush(self):
        with self._lock:
            time.sleep(0.01)  # R8: sleep while holding the lock
            os.fsync(self._fh.fileno())  # R8: disk barrier under the lock

    def wait_for(self, event):
        with self._lock:
            event.wait(1.0)  # R8: Event.wait under the lock


_MOD_LOCK = threading.Lock()


def sync_all(metric_state):
    import torch

    with _MOD_LOCK:
        torch.cuda.synchronize(metric_state.device)  # R8: a card synchronization under a lock
