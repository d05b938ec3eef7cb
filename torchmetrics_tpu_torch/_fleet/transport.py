"""Fleet KV transport: the rendezvous layer of the aggregation tree.

Port of ``torchmetrics_tpu/_fleet/transport.py``. The fleet tier moves metric
state between processes through a key-value rendezvous with a *directory*
access pattern: children publish contributions under namespaced keys carrying
``(node_id, epoch, state_digest)`` and parents sweep their children's
prefixes. Two implementations share that contract:

- :class:`InProcessKV`: a condition-variable KV store for in-process trees
  (tests, chaos schedules, single-host fleets). It is also the
  fault-injection seam: :meth:`InProcessKV.fail_publishes` raises transient
  errors on the next N ``set`` calls (exercising the guarded retry path) and
  :meth:`InProcessKV.stall_publishes` delays them (manufacturing stragglers
  without sleeping in test code).
- :class:`CoordinationServiceKV`: an adapter over a
  ``torch.distributed.Store`` (``set``, ``check``, ``get``, ``list_keys``,
  ``delete_key``), for fleets whose processes share a ``TCPStore``, a
  ``FileStore`` or the default process group's store. The JAX class wraps
  the JAX coordination-service client instead.

Both note every published key into a
:class:`~torchmetrics_tpu_torch.utilities.distributed.KvTtlJanitor` so
orphaned contributions (dead children, abandoned epochs) are reaped instead
of accumulating in the store forever. The locks are plain ``threading``
ones where the JAX package takes its lock sanitizer's.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from torchmetrics_tpu_torch._analysis.locksan import SAN as _SAN
from torchmetrics_tpu_torch._analysis.locksan import check_access as _san_check
from torchmetrics_tpu_torch._analysis.locksan import new_lock as _san_lock
from torchmetrics_tpu_torch.utilities.distributed import KvTtlJanitor, kv_key

__all__ = [
    "FleetTransportError",
    "InjectedKvFault",
    "InProcessKV",
    "CoordinationServiceKV",
    "contribution_key",
    "contribution_prefix",
]


class FleetTransportError(RuntimeError):
    """A (retryable) transport fault while talking to the fleet KV store."""


class InjectedKvFault(FleetTransportError):
    """Transient KV fault injected by the chaos harness."""


def contribution_key(namespace: str, node_id: str, epoch: int, digest: str) -> str:
    """Key one contribution publishes under: ``(node_id, epoch, state_digest)``.

    The digest in the key is the epoch fence's third coordinate: an
    at-least-once redelivery of the *same* payload lands on the same key
    (idempotent overwrite), while a zombie replica pushing *different* state
    for an already-folded epoch shows up as a second key under the same
    ``(node, epoch)`` prefix: visible, countable, and droppable.
    """
    return kv_key("fleet", namespace, "contrib", node_id, int(epoch), digest)


def contribution_prefix(namespace: str, node_id: str, epoch: int) -> str:
    """Prefix a parent sweeps to find one child's contributions for one epoch."""
    return kv_key("fleet", namespace, "contrib", node_id, int(epoch)) + "/"


class InProcessKV:  # concurrency: shared child publisher threads set() while parents sweep
    """Blocking, fault-injectable KV store for in-process fleet trees.

    One condition variable covers the data dict and the injection counters:
    publishers notify waiters on every ``set``, so a parent's deadline wait
    wakes exactly when a child's contribution lands instead of polling.
    """

    def __init__(self, ttl_s: float = 300.0) -> None:
        self._cond = threading.Condition(_san_lock("InProcessKV._cond"))
        self._data: Dict[str, bytes] = {}
        self.janitor = KvTtlJanitor(ttl_s=ttl_s)
        # fault injection (chaos seam): counters guarded by _cond's lock
        self._fail_next = 0
        self._fail_exc: Callable[[], Exception] = lambda: InjectedKvFault("injected transient KV publish fault")
        self._stall_next = 0
        self._stall_s = 0.0
        self.set_calls = 0
        self.faults_injected = 0
        self.stalls_injected = 0

    # ----------------------------------------------------------------- writes
    def set(self, key: str, value: bytes) -> None:
        """Publish one key (at-least-once producer side; overwrite is legal)."""
        stall = 0.0
        with self._cond:
            if _SAN.enabled:
                _san_check(self, "_data,_fail_next,_stall_next")
            self.set_calls += 1
            if self._fail_next > 0:
                self._fail_next -= 1
                self.faults_injected += 1
                raise self._fail_exc()
            if self._stall_next > 0:
                self._stall_next -= 1
                self.stalls_injected += 1
                stall = self._stall_s
        if stall:
            # the stall simulates a slow child OUTSIDE the lock: a stalled
            # publisher must not block every other child's publish
            time.sleep(stall)
        with self._cond:
            self._data[key] = bytes(value)
            self.janitor.note(key)
            self._cond.notify_all()

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)
            self.janitor.forget(key)

    # ------------------------------------------------------------------ reads
    def get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._data.get(key)

    def scan(self, prefix: str) -> Dict[str, bytes]:
        """All current ``key -> value`` pairs under a prefix (snapshot copy)."""
        with self._cond:
            return {k: v for k, v in self._data.items() if k.startswith(prefix)}

    def keys(self, pattern: str = "*") -> List[str]:
        with self._cond:
            return sorted(k for k in self._data if fnmatch.fnmatch(k, pattern))

    def wait_until(
        self,
        predicate: Callable[[Dict[str, bytes]], bool],
        deadline_s: float,
        prefix: str = "",
    ) -> bool:
        """Block until ``predicate(snapshot)`` holds or the deadline expires.

        This is the fan-in deadline primitive: the parent waits for "every
        expected child has published" with a bound, and a timeout is a
        *degrade* signal (partial rollup), never an exception. ``prefix``
        narrows the snapshot the predicate sees (the store transport's scans
        are prefix-directed too).
        """
        deadline = time.monotonic() + max(0.0, float(deadline_s))
        with self._cond:
            while True:
                snapshot = (
                    {k: v for k, v in self._data.items() if k.startswith(prefix)} if prefix else dict(self._data)
                )
                if predicate(snapshot):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)  # lint-ok: R8 Condition.wait releases the lock while blocking

    # ---------------------------------------------------------------- hygiene
    def sweep_expired(self, now: Optional[float] = None) -> List[str]:
        """TTL-reap orphaned keys (dead children, abandoned epochs)."""
        return self.janitor.sweep(self.delete, now=now)

    # ------------------------------------------------------------ chaos seams
    def fail_publishes(self, n: int, exc_factory: Optional[Callable[[], Exception]] = None) -> None:
        """Arm the next ``n`` ``set`` calls to raise a transient fault."""
        with self._cond:
            self._fail_next = int(n)
            if exc_factory is not None:
                self._fail_exc = exc_factory

    def stall_publishes(self, n: int, seconds: float) -> None:
        """Arm the next ``n`` ``set`` calls to sleep ``seconds`` first."""
        with self._cond:
            self._stall_next = int(n)
            self._stall_s = float(seconds)


class CoordinationServiceKV:
    """Fleet KV over a ``torch.distributed.Store``.

    ``store``: any ``torch.distributed.Store`` (``TCPStore``, ``FileStore``,
    ``HashStore``, a ``PrefixStore``); ``None`` takes the default process
    group's store, and raises ``RuntimeError`` when no default group was
    initialized (the JAX class's precondition is
    ``jax.distributed.initialize()``). Nothing substitutes an in-process
    store for a missing one.

    The adapter uses ``set``, ``check``, ``get``, ``list_keys`` and
    ``delete_key``. A store's ``get`` of an absent key blocks until the
    store's timeout, so :meth:`get` asks ``check`` first and returns ``None``
    at once; :meth:`scan` lists the store's keys and keeps those under the
    prefix (a ``FileStore`` lists its own ``efcount/`` key, the default
    group's store its rendezvous keys). A key deleted by another process
    between the listing and its read is skipped. ``wait_until`` polls
    :meth:`scan` at ``poll_s``: a store has no watch on a prefix.
    """

    def __init__(self, store: Any = None, ttl_s: float = 300.0, poll_s: float = 0.05) -> None:
        if store is None:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "CoordinationServiceKV needs a torch.distributed Store or "
                    "torch.distributed.init_process_group() (no default process group)"
                )
            store = dist.distributed_c10d._get_default_store()
        self._store = store
        self.poll_s = float(poll_s)
        self.janitor = KvTtlJanitor(ttl_s=ttl_s)

    def set(self, key: str, value: bytes) -> None:
        self._store.set(key, bytes(value))
        self.janitor.note(key)

    def delete(self, key: str) -> None:
        try:
            self._store.delete_key(key)
        finally:
            self.janitor.forget(key)

    def get(self, key: str) -> Optional[bytes]:
        try:
            if not self._store.check([key]):
                return None
            return bytes(self._store.get(key))
        except Exception:  # noqa: BLE001 - a key deleted after the check surfaces as the store's timeout
            return None

    def scan(self, prefix: str) -> Dict[str, bytes]:
        try:
            keys = sorted(k for k in self._store.list_keys() if k.startswith(prefix))
            out: Dict[str, bytes] = {}
            for key in keys:
                if self._store.check([key]):
                    out[key] = bytes(self._store.get(key))
        except Exception as err:  # noqa: BLE001 - transport fault, retryable upstream
            raise FleetTransportError(f"store scan failed: {err}") from err
        return out

    def wait_until(
        self,
        predicate: Callable[[Dict[str, bytes]], bool],
        deadline_s: float,
        prefix: str = "",
    ) -> bool:
        deadline = time.monotonic() + max(0.0, float(deadline_s))
        while True:
            try:
                snapshot = self.scan(prefix) if prefix else {}
            except FleetTransportError:
                snapshot = {}
            if predicate(snapshot):
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(self.poll_s, remaining))

    def sweep_expired(self, now: Optional[float] = None) -> List[str]:
        return self.janitor.sweep(self.delete, now=now)
