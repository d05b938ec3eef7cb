"""The port's concurrency pass (R7/R8/R9): finding shapes, guard maps, the thread inventory, and the bugs the
pass exists to prevent, driven live on the port's classes.

Counterpart of the JAX package's ``tests/unittests/analysis/test_concurrency.py``.
"""

import threading
import time

import pytest

from torchmetrics_tpu_torch._analysis import analyze_paths, analyze_source, thread_safety_to_json
from torchmetrics_tpu_torch._analysis.concurrency import is_runtime_path
from tests.test_torch_analysis_rules import FIXTURES

PACKAGE = FIXTURES.parents[1] / "torchmetrics_tpu_torch"


def _report(result, name):
    """The ModuleConcurrency report for a fixture, keyed by display path."""
    for path, rep in result.thread_safety.items():
        if path.endswith(name):
            return rep
    raise AssertionError(f"no thread-safety report for {name}: {list(result.thread_safety)}")


def test_r7_messages_cite_the_shared_reason_and_missing_guard():
    by_line = {v.line: v for v in analyze_paths([str(FIXTURES / "viol_r7.py")]).violations}
    assert "scrapes read while workers write" in by_line[13].message  # marker reason
    assert "other sites guard it with" in by_line[34].message  # inconsistent case
    assert "module global" in by_line[41].message


def test_r9_distinguishes_nondaemon_leak_from_abandoned_daemon():
    msgs = {v.line: v.message for v in analyze_paths([str(FIXTURES / "viol_r9.py")]).violations}
    assert "blocks interpreter exit" in msgs[23]
    assert "baselined with a justification" in msgs[27]
    assert "lock-order cycle" in msgs[17]


def test_inline_suppression_works_for_concurrency_rules():
    src = (FIXTURES / "viol_r8.py").read_text().replace(
        "time.sleep(0.01)  # R8: sleep while holding the lock",
        "time.sleep(0.01)  # lint-ok: R8 startup-only path, contention impossible",
    )
    assert ("R8", 16) not in [(v.rule, v.line) for v in analyze_source(src, path="viol_r8.py").violations]


def test_guard_map_inferred_from_with_lock_scopes():
    rep = _report(analyze_paths([str(FIXTURES / "clean_r7.py")]), "clean_r7.py")
    disc = rep.classes["Disciplined"]
    assert disc.shared_reason  # marker recognized
    assert disc.fields["volumes"].verdict == "guarded" and disc.fields["volumes"].guards == ["_lock"]
    assert "flag" not in disc.fields  # plain scalar stores are exempt (GIL-atomic)
    # memo caches (keyed store + keyed read, no iterate/rmw) are exempt
    assert "MemoCache" not in {name for name, c in rep.classes.items() if c.fields}


def test_guarded_by_marker_counts_as_held():
    assert not [v for v in analyze_paths([str(FIXTURES / "clean_r7.py")]).violations if v.rule == "R7"]


def test_thread_inventory_records_target_daemon_join_and_captures():
    rep = _report(analyze_paths([str(FIXTURES / "clean_r9.py")]), "clean_r9.py")
    by_scope = {t.scope: t for t in rep.threads}
    tidy = by_scope["TidyWorker.__init__"]
    assert tidy.target == "self._loop" and tidy.daemon is True and tidy.joined and tidy.captures == ["self"]
    scoped = by_scope["scoped_worker"]
    assert scoped.daemon is False and scoped.joined


def test_module_global_guard_map():
    rep = _report(analyze_paths([str(FIXTURES / "viol_r7.py")]), "viol_r7.py")
    assert rep.global_guards["_PENDING"].verdict == "inconsistent"


def test_manifest_payload_shape_and_runtime_scoping():
    path = "torchmetrics_tpu_torch/_streams/telemetry.py"
    result = analyze_source((PACKAGE / "_streams" / "telemetry.py").read_text(), path=path)
    payload = thread_safety_to_json(result.thread_safety.values())
    assert payload["version"] == 1 and payload["rules"] == ["R7", "R8", "R9"]
    mod = payload["modules"]["torchmetrics_tpu_torch/_streams/telemetry.py"]
    assert mod["verdict"] == "guarded"
    assert mod["classes"]["StreamLabeler"]["fields"]["volumes"] == {"guards": ["_lock"], "verdict": "guarded"}


def test_runtime_path_predicate():
    assert is_runtime_path("torchmetrics_tpu_torch/_observability/telemetry.py")
    assert is_runtime_path("torchmetrics_tpu_torch/metric.py")
    assert is_runtime_path("torchmetrics_tpu_torch/_compile.py")
    assert is_runtime_path("torchmetrics_tpu_torch/utilities/distributed.py")
    assert not is_runtime_path("torchmetrics_tpu_torch/regression/mse.py")
    assert not is_runtime_path("torchmetrics_tpu_torch/utilities/data.py")
    assert not is_runtime_path("torchmetrics_tpu/_observability/telemetry.py")


# ------------------------------------------------- the bugs this pass exists to prevent
def test_streamlabeler_rebalance_is_guarded_against_concurrent_note():
    """Many writer threads and a rebalancer: the labeler never raises 'dict changed size during iteration'."""
    from torchmetrics_tpu_torch._streams.telemetry import StreamLabeler

    labeler = StreamLabeler(k=4, rebalance_every=7)
    errors = []

    def hammer(base):
        try:
            for i in range(800):
                labeler.note(base + (i % 97))
                labeler.label(i % 97)
        except Exception as err:  # noqa: BLE001 - the regression under test
            errors.append(err)

    threads = [threading.Thread(target=hammer, args=(w * 1000,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    labeler.rebalance()
    assert sum(labeler.volumes.values()) == 4 * 800


def test_telemetry_registry_weakref_retire_is_reentrancy_safe():
    """Dropping the last reference while this thread holds the registry lock retires through the pending queue."""
    from torchmetrics_tpu_torch._observability.telemetry import TelemetryRegistry

    registry = TelemetryRegistry()

    class Obj:
        pass

    obj = Obj()
    telem = registry.register(obj)
    telem.inc("update_calls|path=eager")
    with registry._lock:
        del obj  # a callback that took the lock would deadlock here
    assert len(registry._pending_retire) == 1
    agg = registry.aggregate()
    assert agg["Obj"]["retired_instances"] == 1
    assert agg["Obj"]["counters"]["update_calls|path=eager"] == 1


def test_compile_stats_lose_no_count_under_concurrent_replays():
    """C11: the process-wide graph counters are bumped from several threads (a serving worker's pool and the
    caller's metrics); each bump now takes ``_STATS_LOCK``, so none is lost."""
    from torchmetrics_tpu_torch import _compile

    before = _compile.stats()["replayed"]

    def bump():
        for _ in range(20_000):
            _compile._count("replayed")

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _compile.stats()["replayed"] - before == 80_000
    _compile._count("replayed", -80_000)


def test_ledger_flush_waits_for_the_card_outside_its_lock():
    """C12: ``CostLedger.flush`` waited on every pending event pair while holding the ledger lock, so a thread
    recording its steps stalled behind a reader's card synchronization. The wait now runs before the lock."""
    from torchmetrics_tpu_torch._observability.profiling import CostLedger

    ledger = CostLedger()
    waited = []

    class Event:
        def __init__(self, t):
            self.t = t

        def synchronize(self):
            waited.append(ledger._lock.locked())

        def query(self):
            return True

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    with ledger._lock:
        ledger._pending.append(("metric.update", "MeanSquaredError", Event(0.0), Event(0.002), None))
    ledger.flush()
    assert waited == [False]
    assert not ledger._pending
    assert abs(ledger.total_device_seconds() - 0.002) < 1e-12


@pytest.mark.parametrize("kind", ["pool", "engine"])
def test_a_key_warmed_by_two_threads_answers_each_its_own_outcome(kind, tmp_path):
    """C15: a pool's (and an SPMD engine's) ``warm_start`` read how its key was built from one attribute shared by
    every thread, so a thread that built the key could answer the ``"ready"`` of a second thread that took the
    resolution lock after it. The answer is now kept a thread. Forced here: the second thread warms the same key
    between the first's build and its answer."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tp
    from torchmetrics_tpu_torch._aot import set_aot_cache

    set_aot_cache(str(tmp_path / "aot"))
    try:
        metric = tp.MeanSquaredError(device="cpu")
        rows = np.arange(8, dtype=np.float32)
        if kind == "pool":
            runner = metric.to_stream_pool(capacity=4)
            ids = [runner.attach() for _ in range(4)]
            args, step_key = (ids, torch.ones((4, 8)), torch.zeros((4, 8))), "stream_step"
        else:
            from torchmetrics_tpu_torch._spmd import build_mesh

            runner = metric.to_spmd(mesh=build_mesh(devices=["cpu"] * 4))
            args, step_key = (torch.from_numpy(rows), torch.from_numpy(rows)), "spmd_step"
        inner_run, inner_build = runner._run_step, runner._build
        second = {}

        def warm_second():
            second["outcome"] = runner.warm_start(*args)[step_key]

        def build(*a, **kw):
            # the first thread holds the resolution lock: the second passes the "already built" probe and waits
            if "thread" not in second:
                second["thread"] = threading.Thread(target=warm_second)
                second["thread"].start()
                time.sleep(0.5)
            return inner_build(*a, **kw)

        def run_step(*a, **kw):
            out = inner_run(*a, **kw)
            if threading.current_thread() is not second.get("thread") and "thread" in second:
                second["thread"].join()  # the lock is free: the second thread answers before the first does
            return out

        runner._build, runner._run_step = build, run_step
        first = runner.warm_start(*args)[step_key]
        assert (first, second["outcome"]) == ("compiled", "ready")
    finally:
        set_aot_cache(None)
