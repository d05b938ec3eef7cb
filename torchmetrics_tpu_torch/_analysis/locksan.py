"""Runtime lock-discipline sanitizer (``TM_TPU_LOCKSAN``).

The static concurrency pass (``concurrency.py``, rules R7-R9) *infers* the
runtime's lock discipline and writes it to ``thread_safety.json``. This
module *verifies* that inferred discipline on live threads, so the chaos
soak and the streams golden sweep exercise the declared guard map instead
of trusting it:

- :func:`new_lock` is the lock factory the instrumented runtime classes
  use. Disabled (the default), it returns a plain ``threading.Lock`` —
  the hot path is indistinguishable from a build without the sanitizer.
  Enabled, it returns a :class:`SanLock` that tracks per-thread held sets,
  flags reentrant acquisition of a non-reentrant lock (the shape of the
  gc-time weakref-callback deadlock fixed in ``TelemetryRegistry``), and
  records the cross-lock acquisition-order graph, reporting any cycle the
  moment the second edge direction appears (the runtime twin of the static
  R9 lock-order check).
- :func:`check_access` asserts, at an instrumented field-access site, that
  the current thread holds every lock the manifest's guard map declares
  for ``type(obj).__name__ + "." + field`` (the runtime twin of R7).

Instrumentation sites follow the telemetry kill-switch contract exactly
(``_observability/state.py``): every site is
``if SAN.enabled: check_access(...)`` — one slot load and one branch when
disabled.

:func:`new_rlock` is the factory for the one lock the port holds
reentrantly by design (the AOT cache's ``RESOLVE_LOCK``, under which a
pool's or an engine's build probes its own steps again): enabled, it
returns a :class:`SanRLock`, which admits reentry by its owner and records
lock order on the outermost acquisition only.

Enable with env ``TM_TPU_LOCKSAN=1`` (read at import, so even import-time
singletons get instrumented locks) or :func:`set_locksan_enabled(True)`
at runtime — the setter retrofits the process-wide singletons
(``EventBus``/``TelemetryRegistry``/the guarded-sync worker-pool lock)
with instrumented locks; objects constructed afterwards pick them up via
:func:`new_lock`. Violations raise :class:`LockDisciplineError` at the
offending site *and* are recorded in :func:`violations` so harnesses can
assert a clean run even where the raise was swallowed by a degradation
path.

This module must stay import-light (no torch, no numpy): the instrumented
runtime modules import it at module scope.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "SAN",
    "LockDisciplineError",
    "SanLock",
    "check_access",
    "locksan_enabled",
    "SanRLock",
    "new_lock",
    "new_rlock",
    "reset",
    "set_locksan_enabled",
    "violations",
]


class LockDisciplineError(AssertionError):
    """A thread violated the statically-declared lock discipline."""


class _SanState:
    """Process-wide sanitizer switch (same ``__slots__`` contract as OBS)."""

    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = os.environ.get("TM_TPU_LOCKSAN", "") == "1"


SAN = _SanState()

_tls = threading.local()  # .held: the SanLocks/SanRLocks this thread holds, in acquisition order

# sanitizer bookkeeping shared across threads — guarded by _meta_lock
# (the sanitizer must satisfy its own discipline)
_meta_lock = threading.Lock()
_order_edges: Dict[Tuple[str, str], str] = {}  # (outer, inner) -> first site
_violations: List[str] = []


def _held() -> List[object]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _report(message: str) -> None:
    with _meta_lock:
        _violations.append(message)
    raise LockDisciplineError(message)


def violations() -> List[str]:
    """Every discipline violation recorded since the last :func:`reset`."""
    with _meta_lock:
        return list(_violations)


def reset() -> None:
    """Clear recorded violations and the acquisition-order graph (tests)."""
    with _meta_lock:
        _violations.clear()
        _order_edges.clear()


def locksan_enabled() -> bool:
    return SAN.enabled


class SanLock:
    """Instrumented non-reentrant lock: holder tracking + order recording.

    Lock identity for the order graph is the *label* (``Class._lock``),
    deliberately instance-agnostic: two instances of the same class locked
    in opposite orders on two threads is exactly the ABBA deadlock the
    merge is conservative about.
    """

    __slots__ = ("_lock", "label")

    def __init__(self, label: str) -> None:
        self._lock = threading.Lock()
        self.label = label

    # ------------------------------------------------------------- protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if any(lock is self for lock in held):
            _report(
                f"reentrant acquire of non-reentrant lock `{self.label}` — this thread already"
                " holds it and would deadlock (the gc-time weakref-callback shape)"
            )
        for outer in held:
            if outer.label != self.label:
                _note_edge(outer.label, self.label)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append(self)
        return ok

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._lock.release()

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        return any(lock is self for lock in _held())

    # ``threading.Condition(SanLock(...))`` protocol: the condition asks the
    # lock who owns it and releases/reacquires it around a wait, instead of
    # probing with a non-blocking acquire (which would report reentry)
    def _is_owned(self) -> bool:
        return self.held_by_current_thread()

    def _release_save(self) -> None:
        self.release()

    def _acquire_restore(self, _state: None) -> None:
        self.acquire()


class SanRLock:
    """Instrumented reentrant lock: reentry by its owner is the design.

    Order edges are recorded when the outermost acquisition happens (a
    reentry takes no new lock), and the lock sits once in the thread's held
    list however deep the reentry goes.
    """

    __slots__ = ("_lock", "label", "_depth")

    def __init__(self, label: str) -> None:
        self._lock = threading.RLock()
        self.label = label
        self._depth = 0  # owner's reentry depth; read and written by the owner only

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if any(lock is self for lock in held):
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._depth += 1
            return ok
        for outer in held:
            if outer.label != self.label:
                _note_edge(outer.label, self.label)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._depth = 1
            held.append(self)
        return ok

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._lock.release()

    def __enter__(self) -> "SanRLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def held_by_current_thread(self) -> bool:
        return any(lock is self for lock in _held())


def _note_edge(outer: str, inner: str) -> None:
    """Record ``outer -> inner`` and fail fast when it closes a cycle."""
    with _meta_lock:
        if (outer, inner) in _order_edges:
            return
        site = f"{outer} -> {inner}"
        _order_edges[(outer, inner)] = site
        # DFS from `inner` back to `outer` over the recorded graph
        stack, seen = [inner], set()
        while stack:
            node = stack.pop()
            if node == outer:
                path = [e for e in _order_edges if e[0] == inner or e[1] == outer]
                message = (
                    f"lock-order cycle closed by `{outer}` -> `{inner}`: another thread path"
                    f" acquires these locks in the opposite order ({sorted(path)}) — deadlock"
                    " under load (static rule R9, verified live)"
                )
                _violations.append(message)
                raise LockDisciplineError(message)
            if node in seen:
                continue
            seen.add(node)
            stack.extend(b for (a, b) in _order_edges if a == node)


def new_lock(label: str) -> object:
    """The runtime's lock factory: plain ``Lock`` off, :class:`SanLock` on."""
    if SAN.enabled:
        return SanLock(label)
    return threading.Lock()


def new_rlock(label: str) -> object:
    """The factory for a reentrant lock: plain ``RLock`` off, :class:`SanRLock` on."""
    if SAN.enabled:
        return SanRLock(label)
    return threading.RLock()


def check_access(obj: object, fields: str) -> None:
    """Assert the declared guard(s) for ``fields`` are held by this thread.

    ``fields`` may name several comma-separated fields sharing one site.
    Guards come from the checked-in ``thread_safety.json`` guard map
    (``manifest.guard_map``); a guard lock that is a plain ``Lock``
    (created while the sanitizer was disabled) cannot report holders and
    is skipped — enable the sanitizer before constructing the objects
    under test (or use :func:`set_locksan_enabled`, which retrofits the
    process singletons).
    """
    from torchmetrics_tpu_torch._analysis.manifest import guard_map

    gmap = guard_map()
    cls_name = type(obj).__name__
    for field in fields.split(","):
        field = field.strip()
        guards = gmap.get(f"{cls_name}.{field}")
        if not guards:
            continue
        for guard in guards:
            lock = getattr(obj, guard, None)
            if isinstance(lock, threading.Condition):
                lock = lock._lock  # a condition guards with the lock it was built on
            if isinstance(lock, (SanLock, SanRLock)) and not lock.held_by_current_thread():
                _report(
                    f"access to `{cls_name}.{field}` without holding its declared guard"
                    f" `{guard}` (thread {threading.current_thread().name!r}) — the"
                    " statically-inferred discipline in thread_safety.json was violated live"
                )


# the locks built at import, which objects constructed after enabling cannot
# pick up from the factories: (module, singleton or None for a module
# global, attribute, label, reentrant)
_IMPORT_TIME_LOCKS = (
    ("torchmetrics_tpu_torch._observability.events", "BUS", "_lock", "EventBus._lock", False),
    ("torchmetrics_tpu_torch._observability.telemetry", "REGISTRY", "_lock", "TelemetryRegistry._lock", False),
    ("torchmetrics_tpu_torch._resilience.guard", None, "_worker_lock", "guard._worker_lock", False),
    ("torchmetrics_tpu_torch._observability.slo", None, "_tracker_lock", "slo._tracker_lock", False),
    ("torchmetrics_tpu_torch._observability.flight", None, "_active_lock", "flight._active_lock", False),
    ("torchmetrics_tpu_torch._compile", None, "_STATS_LOCK", "compile._STATS_LOCK", False),
    ("torchmetrics_tpu_torch._aot.cache", None, "_CACHES_LOCK", "aot._CACHES_LOCK", False),
    ("torchmetrics_tpu_torch._aot.cache", None, "RESOLVE_LOCK", "aot.RESOLVE_LOCK", True),
)


def set_locksan_enabled(flag: bool) -> None:
    """Runtime switch. Enabling retrofits the locks built at import.

    Objects constructed *after* enabling get instrumented locks via
    :func:`new_lock`; the import-time ones (the event bus, the telemetry
    registry, the guarded-sync worker pool, the SLO tracker's and the flight
    recorder's module locks, the graph counters' lock, the AOT caches' table
    lock and its reentrant resolution lock) are re-locked here so tests need
    not re-import the package. Disabling reverts them to plain locks. Never
    call this while runtime threads are mid-critical-section (tests/harness
    boundaries only).
    """
    SAN.enabled = bool(flag)
    # late imports: locksan must stay importable before the runtime packages
    for module, singleton, attr, label, reentrant in _IMPORT_TIME_LOCKS:
        owner = importlib.import_module(module)
        if singleton is not None:
            owner = getattr(owner, singleton)
        sanitized = isinstance(getattr(owner, attr), (SanLock, SanRLock))
        if flag and not sanitized:
            setattr(owner, attr, SanRLock(label) if reentrant else SanLock(label))
        elif not flag and sanitized:
            # revert so a long-lived process (the test suite) doesn't keep
            # paying the bookkeeping after the sanitized section ends
            setattr(owner, attr, threading.RLock() if reentrant else threading.Lock())
