"""False-positive fixture for R9: consistent lock order + joined threads."""

import threading

_LOCK_A = threading.Lock()
_LOCK_B = threading.Lock()


def path_one():
    with _LOCK_A:
        with _LOCK_B:  # A -> B everywhere: a DAG, not a cycle
            return 1


def path_two():
    with _LOCK_A:
        with _LOCK_B:
            return 2


class TidyWorker:
    """The snapshot-writer idiom: the spawned thread is joined in close()."""

    def __init__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        pass

    def close(self):
        self._thread.join(30.0)


def scoped_worker():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return True
