"""True-positive fixture for R9: lock-order cycles + thread-lifecycle leaks."""

import threading

_LOCK_A = threading.Lock()
_LOCK_B = threading.Lock()


def path_one():
    with _LOCK_A:
        with _LOCK_B:  # acquires A -> B
            return 1


def path_two():
    with _LOCK_B:
        with _LOCK_A:  # acquires B -> A: closes the cycle
            return 2


class LeakyWorkers:
    def start_writer(self):
        t = threading.Thread(target=self._write_loop)  # R9: non-daemon, never joined
        t.start()

    def start_watchdog(self):
        threading.Thread(target=self._watch, daemon=True).start()  # R9: abandoned daemon

    def _write_loop(self):
        pass

    def _watch(self):
        pass
