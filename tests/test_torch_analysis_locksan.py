"""The port's runtime lock-discipline sanitizer (``TM_TPU_LOCKSAN``).

The sanitizer verifies live what the concurrency pass inferred statically:
guard-map field accesses, reentrant acquisition of non-reentrant locks, and
cross-lock acquisition-order cycles. Disabled, its factories hand out plain
``threading`` locks. Counterpart of the JAX package's
``tests/unittests/analysis/test_locksan.py``, plus the port's reentrant
variant (the AOT cache's ``RESOLVE_LOCK``) and a condition built on a
sanitized lock (the fleet's in-process KV).
"""

import threading

import pytest

from torchmetrics_tpu_torch._analysis import locksan
from torchmetrics_tpu_torch._analysis.locksan import (
    LockDisciplineError,
    SanLock,
    SanRLock,
    check_access,
    new_lock,
    new_rlock,
    set_locksan_enabled,
)


@pytest.fixture()
def san():
    set_locksan_enabled(True)
    locksan.reset()
    yield locksan
    set_locksan_enabled(False)
    locksan.reset()


def test_disabled_factories_return_plain_locks():
    set_locksan_enabled(False)
    lock, rlock = new_lock("X._lock"), new_rlock("X._rlock")
    assert not isinstance(lock, SanLock) and not isinstance(rlock, SanRLock)
    assert isinstance(lock, type(threading.Lock())) and isinstance(rlock, type(threading.RLock()))
    with lock, rlock, rlock:  # still working locks; the RLock reenters
        pass


def test_enabled_factory_returns_an_instrumented_lock(san):
    lock = new_lock("X._lock")
    assert isinstance(lock, SanLock)
    with lock:
        assert lock.held_by_current_thread()
    assert not lock.held_by_current_thread()


def test_reentrant_acquire_is_reported(san):
    lock = SanLock("X._lock")
    with lock:
        with pytest.raises(LockDisciplineError, match="reentrant acquire"):
            lock.acquire()
    assert any("reentrant" in v for v in locksan.violations())


def test_the_reentrant_variant_admits_its_owner(san):
    rlock = new_rlock("aot.RESOLVE_LOCK")
    assert isinstance(rlock, SanRLock)
    with rlock:
        with rlock:  # a seam holding it calls back into wrap_executable
            assert rlock.held_by_current_thread()
        assert rlock.held_by_current_thread()
    assert not rlock.held_by_current_thread()
    assert locksan.violations() == []


def test_the_reentrant_variant_records_lock_order_once(san):
    rlock, inner = SanRLock("R"), SanLock("I")
    with rlock:
        with rlock:
            with inner:  # records R -> I once, however deep the reentry
                pass
    with inner:
        with pytest.raises(LockDisciplineError, match="lock-order cycle"):
            with rlock:  # closes the cycle: I -> R
                pass


def test_lock_order_cycle_is_reported_at_the_closing_edge(san):
    a, b = SanLock("A"), SanLock("B")
    with a:
        with b:  # records A -> B
            pass
    with b:
        with pytest.raises(LockDisciplineError, match="lock-order cycle"):
            with a:  # closes the cycle: B -> A
                pass


def test_consistent_order_never_fires(san):
    a, b = SanLock("A"), SanLock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert locksan.violations() == []


def test_guard_map_assertion_catches_an_unguarded_access(san):
    # StreamLabeler.volumes -> ["_lock"] in the checked-in manifest; a
    # labeler constructed with the sanitizer on carries a SanLock
    from torchmetrics_tpu_torch._streams.telemetry import StreamLabeler

    labeler = StreamLabeler(k=2)
    assert isinstance(labeler._lock, SanLock)
    with pytest.raises(LockDisciplineError, match="StreamLabeler.volumes"):
        check_access(labeler, "volumes")
    with labeler._lock:
        check_access(labeler, "volumes")  # held: clean


def test_a_condition_on_a_sanitized_lock_waits_and_is_checked(san):
    """The fleet's in-process KV guards its data with a condition; the sanitizer sees through it to its lock."""
    from torchmetrics_tpu_torch._fleet.transport import InProcessKV

    kv = InProcessKV()
    assert isinstance(kv._cond._lock, SanLock)
    with pytest.raises(LockDisciplineError, match="InProcessKV._data"):
        check_access(kv, "_data")
    locksan.reset()
    setter = threading.Timer(0.05, kv.set, args=("k", b"v"))
    setter.start()
    assert kv.wait_until(lambda snapshot: "k" in snapshot, deadline_s=5.0)  # waits on the condition, lock released
    setter.join()
    assert kv.get("k") == b"v"
    assert locksan.violations() == []


def test_instrumented_hot_paths_run_clean(san):
    # the real instrumentation sites (note/publish/aggregate) satisfy their
    # own declared discipline with the sanitizer armed
    from torchmetrics_tpu_torch._observability import set_telemetry_enabled
    from torchmetrics_tpu_torch._observability.events import BUS
    from torchmetrics_tpu_torch._observability.telemetry import REGISTRY
    from torchmetrics_tpu_torch._streams.telemetry import StreamLabeler

    labeler = StreamLabeler(k=2, rebalance_every=3)
    for i in range(10):
        labeler.note(i % 5)
    set_telemetry_enabled(True)
    try:
        BUS.publish("locksan_test", "test", "hello")
        REGISTRY.aggregate()
    finally:
        set_telemetry_enabled(False)
        BUS.clear()
    assert locksan.violations() == []


def test_setter_retrofits_the_process_singletons(san):
    from torchmetrics_tpu_torch._observability.events import BUS
    from torchmetrics_tpu_torch._observability.telemetry import REGISTRY
    from torchmetrics_tpu_torch._resilience import guard

    assert isinstance(BUS._lock, SanLock)
    assert isinstance(REGISTRY._lock, SanLock)
    assert isinstance(guard._worker_lock, SanLock)
    from torchmetrics_tpu_torch import _compile
    from torchmetrics_tpu_torch._aot import cache as aot_cache

    # the port's own import-time locks too: the reentrant one keeps its reentrancy
    assert isinstance(aot_cache.RESOLVE_LOCK, SanRLock) and isinstance(aot_cache._CACHES_LOCK, SanLock)
    assert isinstance(_compile._STATS_LOCK, SanLock)
    set_locksan_enabled(False)
    assert not isinstance(BUS._lock, SanLock) and not isinstance(guard._worker_lock, SanLock)
    assert isinstance(aot_cache.RESOLVE_LOCK, type(threading.RLock()))


def test_violations_survive_for_harness_assertions(san):
    lock = SanLock("Y._lock")
    with lock:
        try:
            lock.acquire()
        except LockDisciplineError:
            pass
    assert len(locksan.violations()) == 1
    locksan.reset()
    assert locksan.violations() == []


def test_every_guard_in_the_manifest_is_built_by_the_sanitizers_factories(san):
    """A guard built as a plain lock could not report its holder, and ``check_access`` would skip it: every
    lock the port's ``thread_safety.json`` names as a guard is a SanLock (or a condition on one) once armed."""
    from torchmetrics_tpu_torch._analysis.manifest import load_thread_safety
    from torchmetrics_tpu_torch._aot.cache import AotCache
    from torchmetrics_tpu_torch._fleet.observe import RegionLabeler
    from torchmetrics_tpu_torch._observability.flight import FlightRecorder
    from torchmetrics_tpu_torch._observability.profiling import CostLedger
    from torchmetrics_tpu_torch._observability.slo import SloTracker
    from torchmetrics_tpu_torch._observability.tracing import SpanRecorder
    from torchmetrics_tpu_torch._serving.controller import BatchController
    from torchmetrics_tpu_torch._serving.queue import IngressQueue
    from torchmetrics_tpu_torch._streams.telemetry import StreamLabeler
    from torchmetrics_tpu_torch.utilities.distributed import KvTtlJanitor

    guards = {
        (cls, guard)
        for mod in load_thread_safety().values()
        for cls, entry in (mod.get("classes") or {}).items()
        for field in (entry.get("fields") or {}).values()
        for guard in field["guards"]
    }
    built = {
        "AotCache": lambda: AotCache("unused"), "BatchController": BatchController, "CostLedger": CostLedger,
        "FlightRecorder": FlightRecorder, "IngressQueue": lambda: IngressQueue(4), "KvTtlJanitor": KvTtlJanitor,
        "RegionLabeler": RegionLabeler, "SloTracker": SloTracker, "SpanRecorder": SpanRecorder,
        "StreamLabeler": StreamLabeler,
    }
    from torchmetrics_tpu_torch._observability.events import BUS
    from torchmetrics_tpu_torch._observability.telemetry import REGISTRY

    singletons = {"EventBus": BUS, "TelemetryRegistry": REGISTRY}
    checked = set()
    for cls, guard in sorted(guards):
        obj = singletons[cls] if cls in singletons else built[cls]() if cls in built else None
        if obj is None:
            continue  # built only with a live pool, server or node: held by the sanitized runs
        lock = getattr(obj, guard)
        lock = getattr(lock, "_lock", lock) if isinstance(lock, threading.Condition) else lock
        assert isinstance(lock, SanLock), (cls, guard, type(lock))
        checked.add(cls)
    assert {"StreamLabeler", "EventBus", "TelemetryRegistry", "CostLedger", "AotCache"} <= checked
    assert {g for c, g in guards if c in ("MetricServer", "AggregationNode")} == {"_pool_lock", "_pub_lock"}
