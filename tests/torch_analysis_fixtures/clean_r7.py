"""False-positive fixture for R7: the same shapes, disciplined."""

import threading


class Disciplined:  # concurrency: shared scrapes read while workers write
    """One lock guards every mutate/iterate site -> guard-map entry, no finding."""

    def __init__(self):
        self._lock = threading.Lock()
        self.volumes = {}
        self.flag = False  # plain scalar store: GIL-atomic, exempt

    def note(self, sid):
        with self._lock:
            self.volumes[sid] = self.volumes.get(sid, 0) + 1
        self.flag = True

    def top(self):
        with self._lock:
            return sorted(self.volumes.items())

    def _compact(self):  # concurrency: guarded-by _lock
        # locked-caller precondition: analyzed as if _lock were held
        self.volumes.clear()


class MemoCache:  # concurrency: shared many threads consult the cache
    """Keyed stores + keyed reads, never iterated, never compound: exempt."""

    def __init__(self):
        self._cache = {}

    def put(self, key, value):
        self._cache[key] = value

    def get(self, key):
        return self._cache.get(key)


class NotShared:
    """No marker, no threads, no singleton: single-threaded by construction."""

    def __init__(self):
        self.rows = {}

    def add(self, k):
        self.rows[k] = self.rows.get(k, 0) + 1

    def dump(self):
        return dict(self.rows)


class SafeTypes:
    """Queue/Event fields are intrinsically synchronized: exempt."""

    def __init__(self):
        import queue

        self._lock = threading.Lock()
        self._jobs = queue.Queue()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        self._jobs.get()
        self._done.set()

    def close(self):
        self._thread.join()
