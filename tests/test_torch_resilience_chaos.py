"""The port's chaos harness against the JAX package's, on the CPU.

From ``tests/unittests/resilience/test_chaos.py``: seeded fault schedules
(preemption kill/restore, snapshot corruption, NaN batches, transient
collective failures and stalls) against real metrics, each checked for the
three invariants (golden equality, idempotent restore, the wall-clock
budget). The faults are drawn from the seed alone, so each seed's NaN
batches, kills and final faults here are the JAX package's, and the smoke
tests hold them equal. As
in the JAX suite, the smoke seeds run in tier-1 and the soak seeds under
``-m slow``. The factories build on the CPU (``device="cpu"``).
"""

import functools
import json
import threading
import warnings

import pytest

from tests.test_torch_resilience_integrity import JAX, PORT

CPU = {"device": "cpu"}
metric_factory = functools.partial(PORT.chaos.default_metric_factory, **CPU)
collection_factory = functools.partial(PORT.chaos.default_collection_factory, **CPU)


def _run(seed, **kwargs):
    # degradation warnings (quarantine drops, restore fallbacks) are the stack working as designed
    kwargs.setdefault("factory", metric_factory)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = PORT.chaos.run_chaos_schedule(seed, **kwargs)
    assert result.ok, result.describe()
    return result


def _jax_run(seed, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = JAX.chaos.run_chaos_schedule(seed, **kwargs)
    assert result.ok, result.describe()
    return result


def _schedule(result):
    """The faults drawn from the seed. A restore's generation and a corruption depend on which async writes
    landed before a kill, in either package, so they stay out."""
    return [(e.step, e.kind) for e in result.events if e.kind in ("nan", "preempt", "final_fault")], result.preemptions


# --------------------------------------------------------------- tier-1 smoke
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_smoke_metric(seed):
    assert _schedule(_run(seed)) == _schedule(_jax_run(seed))


def test_chaos_smoke_collection():
    got = _run(100, factory=collection_factory)
    assert _schedule(got) == _schedule(_jax_run(100, factory=JAX.chaos.default_collection_factory))


def test_chaos_smoke_watchdog_stall():
    spec = PORT.chaos.ChaosSpec(stall_final=True)
    got = _run(101, spec=spec)
    assert _schedule(got) == _schedule(_jax_run(101, spec=JAX.chaos.ChaosSpec(stall_final=True)))


def test_chaos_smoke_under_locksan():
    """The chaos schedule runs clean with the lock sanitizer armed: the guarded-sync workers, the snapshot writer,
    the event bus and the telemetry registry hold their declared discipline live, the watchdog stall included, and
    no snapshot writer outlives the run."""
    from torchmetrics_tpu_torch._analysis import locksan

    locksan.set_locksan_enabled(True)
    locksan.reset()
    try:
        _run(7)
        _run(102, spec=PORT.chaos.ChaosSpec(stall_final=True))
        assert locksan.violations() == []
    finally:
        locksan.set_locksan_enabled(False)
        locksan.reset()
    assert not [t for t in threading.enumerate() if t.name == "tm-tpu-snapshot-writer" and t.is_alive()]


def test_chaos_exercises_the_fault_surface():
    kinds = set()
    for seed in (0, 1, 2, 3, 4, 5):
        kinds |= {e.kind for e in _run(seed).events}
        if {"preempt", "restore", "nan", "final_fault", "corrupt"} <= kinds:
            break
    assert {"preempt", "restore", "nan", "final_fault", "corrupt"} <= kinds, kinds


# ----------------------------------------------------------------- full soak
@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_chaos_soak_metric(seed):
    _run(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(200, 206))
def test_chaos_soak_collection(seed):
    _run(seed, factory=collection_factory)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(300, 304))
def test_chaos_soak_watchdog_stall(seed):
    _run(seed, spec=PORT.chaos.ChaosSpec(stall_final=True, wallclock_budget_s=12.0))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(400, 404))
def test_chaos_soak_sync_writes(seed):
    _run(seed, spec=PORT.chaos.ChaosSpec(async_write=False))


# ----------------------------------------------- every fault leaves a flight dump
def test_chaos_faults_produce_flight_dumps(tmp_path):
    """With telemetry and tracing on and the flight recorder armed, one dump per trigger, each fault class
    represented at its seam with the trace id of the failing batch."""
    obs = PORT.tm._observability
    from torchmetrics_tpu_torch._observability.tracing import TRACER, set_tracing_enabled

    obs.set_telemetry_enabled(True)
    set_tracing_enabled(True)
    TRACER.clear()
    obs.BUS.clear()
    recorder = obs.arm_flight_recorder(directory=str(tmp_path), keep=256)
    try:
        result = _run(2)
        kinds = {e.kind for e in result.events}
        assert {"nan", "preempt", "restore", "corrupt", "final_fault"} <= kinds, kinds
        dumps = recorder.dumps()
        assert dumps
        seqs = [d["trigger"]["seq"] for d in dumps]
        assert len(seqs) == len(set(seqs)) and len(dumps) == recorder.dump_count

        def where(pred):
            return [d for d in dumps if pred(d)]

        preempts = where(lambda d: d["trigger"]["kind"] == "chaos_fault" and d["trigger"]["data"].get("fault") == "preemption")
        assert len(preempts) == result.preemptions
        preempt_traces = {e.trace_id for e in result.events if e.kind == "preempt"}
        for d in preempts:
            assert d["seam"] == "snapshot.restore" and d["trace_attribution"] == "ambient"
            assert d["trace_id"] in preempt_traces
        nans = where(lambda d: d["trigger"]["kind"] == "degradation" and d["trigger"]["data"].get("kind") == "nan_quarantine")
        assert {e.trace_id for e in result.events if e.kind == "nan"} <= {d["trace_id"] for d in nans}
        fallbacks = where(lambda d: d["trigger"]["kind"] == "degradation" and d["trigger"]["data"].get("kind") == "snapshot_restore")
        for d in fallbacks:
            assert d["seam"] == "snapshot.restore"
        assert {e.trace_id for e in result.events if e.kind == "corrupt"} <= {d["trace_id"] for d in fallbacks}
        finals = where(lambda d: d["trigger"]["data"].get("fault") in ("collective_failure", "collective_stall"))
        assert finals and {d["trace_id"] for d in finals} == {e.trace_id for e in result.events if e.kind == "final_fault"}
        for d in finals:
            assert d["seam"] == "guard.sync"
        files = sorted(tmp_path.glob("flight_*.json"))
        assert len(files) == len(dumps)
        assert {"seam", "trace_id", "trigger", "timeline"} <= set(json.loads(files[0].read_text(encoding="utf-8")))
    finally:
        obs.disarm_flight_recorder()
        set_tracing_enabled(False)
        obs.set_telemetry_enabled(False)
        TRACER.clear()
        obs.BUS.clear()
        obs.REGISTRY.reset()


def test_failing_schedule_does_not_leak_writer_thread(tmp_path):
    """A schedule that raises mid-stream still closes its manager: no writer thread, no open journal."""

    class _Boom(PORT.tm.MeanSquaredError):
        def __init__(self):
            super().__init__(device="cpu")

        def update(self, preds, target):
            if self._update_count >= 2:
                raise RuntimeError("boom")
            super().update(preds, target)

    before = threading.active_count()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = PORT.chaos.run_chaos_schedule(seed=0, factory=_Boom, directory=tmp_path)
    assert not result.ok and any("boom" in f for f in result.failures)
    assert not [t for t in threading.enumerate() if t.name == "tm-tpu-snapshot-writer" and t.is_alive()]
    assert threading.active_count() <= before


def test_default_factories_take_a_device():
    """The default factories build on ``cuda`` unless told otherwise; the batches follow the target."""
    m = PORT.chaos.default_metric_factory(device="cpu")
    c = PORT.chaos.default_collection_factory(device="cpu")
    assert m.device.type == "cpu" and m.nan_policy == "quarantine"
    assert [x.nan_policy for x in c.values()] == ["quarantine", "quarantine"]
    assert PORT.snapshot._target_device(c).type == "cpu"
