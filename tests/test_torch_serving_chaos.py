"""Chaos under load against the port's server (``tests/unittests/serving/test_serving_chaos.py``).

The counterparts of the JAX suite's tests, on CPU metrics
(``device="cpu"``): fixed-seed smokes, bounded preemption recovery, flight
dumps per fault, the soak runner, and the multi-seed soaks under ``-m slow``
as in the JAX suite. The smokes also run the JAX package's harness on the
same seed and hold the port to it: the same pre-drawn faults, the same
acked, quarantined and rejected counts, and every tenant's final served
value at rtol 1e-6 (float32 sums of the same acked rows). The JAX suite
runs one schedule under its lock sanitizer; the port has none, and
``test_serving_chaos_leaves_no_worker_or_pending_ack`` asserts instead that
after a fault-heavy schedule no ingest worker is alive and no ack is left
pending.
"""

from __future__ import annotations

import importlib
import threading
import warnings

import numpy as np
import pytest

from torchmetrics_tpu_torch._serving import ServingChaosSpec, run_serving_chaos, run_serving_chaos_soak

RTOL = 1e-6


def _run(seed, **kwargs):
    # degradation warnings (quarantine drops, sync retries, recompiles) are
    # the stack WORKING as designed mid-schedule — only the invariants matter
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = run_serving_chaos(seed, device="cpu", **kwargs)
    assert result.ok, result.describe()
    return result


def _served(pkg, seed, monkeypatch):
    """One package's schedule for ``seed``, with the values its server holds for each tenant at the end."""
    chaos = importlib.import_module(pkg + "._serving.chaos")
    servers = []

    class Recorded(chaos.MetricServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    monkeypatch.setattr(chaos, "MetricServer", Recorded)
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = chaos.run_serving_chaos(seed, **kw)
    pool = servers[0].pool
    values = {sid: float(np.asarray(pool.compute(sid))) for sid in pool.active_streams}
    return result, values


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_chaos_smoke(seed, monkeypatch):
    result, values = _served("torchmetrics_tpu_torch", seed, monkeypatch)
    assert result.ok, result.describe()
    assert result.acked > 0
    assert result.golden_equal and result.within_budget
    want, want_values = _served("torchmetrics_tpu", seed, monkeypatch)
    assert want.ok, want.describe()
    assert result.events == want.events
    for field in ("acked", "quarantined", "rejected", "preemptions", "fault_events"):
        assert getattr(result, field) == getattr(want, field), field
    assert sorted(values) == sorted(want_values)
    for sid in want_values:
        assert values[sid] == pytest.approx(want_values[sid], rel=RTOL)


def test_serving_chaos_preemption_recovery_is_bounded():
    """Seed 0's schedule includes preemption kills; every recovery lands inside the spec budget and no
    acknowledged batch is lost across the kill (golden equality covers it)."""
    spec = ServingChaosSpec(recovery_budget_ms=30000)
    result = _run(0, spec=spec)
    assert result.preemptions >= 1, "seed 0 must exercise the preemption path"
    assert len(result.recovery_ms) == result.preemptions
    assert all(0.0 < ms < spec.recovery_budget_ms for ms in result.recovery_ms)


def test_serving_chaos_leaves_no_worker_or_pending_ack(monkeypatch):
    """The counterpart of the JAX suite's run under its lock sanitizer: seed 2's fault-heavy schedule ends with
    every server stopped, no ingest worker alive and no ack pending."""
    chaos = importlib.import_module("torchmetrics_tpu_torch._serving.chaos")
    acks = []
    submit = chaos.MetricServer.submit

    def recording_submit(self, *args, **kwargs):
        ack = submit(self, *args, **kwargs)
        acks.append(ack)
        return ack

    monkeypatch.setattr(chaos.MetricServer, "submit", recording_submit)
    result = _run(2)
    assert acks and result.acked == len(acks)  # a rejected request raises and never gets an ack
    assert [a.state for a in acks if a.state == "pending"] == []
    assert not [t for t in threading.enumerate() if t.name == "tm-serving-ingest" and t.is_alive()]


def test_serving_chaos_under_locksan():
    """The whole serving loop (client threads, ingest worker, snapshot journal, controller, event bus) holds its
    declared lock discipline live under a fault-heavy schedule."""
    from torchmetrics_tpu_torch._analysis import locksan

    locksan.set_locksan_enabled(True)
    locksan.reset()
    try:
        _run(2)
        assert locksan.violations() == [], locksan.violations()
    finally:
        locksan.set_locksan_enabled(False)
        locksan.reset()


def test_serving_chaos_faults_produce_flight_dumps(tmp_path):
    """Every injected fault (preemption kill, collective failure) freezes exactly one ``chaos_fault``
    post-mortem with the right seam; dumps are deduplicated per bus event."""
    from torchmetrics_tpu_torch._observability import (
        BUS,
        REGISTRY,
        arm_flight_recorder,
        disarm_flight_recorder,
        set_telemetry_enabled,
    )

    set_telemetry_enabled(True)
    BUS.clear()
    recorder = arm_flight_recorder(directory=str(tmp_path), keep=256)
    try:
        result = _run(0)
        assert result.fault_events >= 1
        dumps = [d for d in recorder.dumps() if d["trigger"]["kind"] == "chaos_fault"]
        assert len(dumps) == result.fault_events, (len(dumps), result.fault_events)
        seqs = [d["trigger"]["seq"] for d in dumps]
        assert len(seqs) == len(set(seqs)), "one dump per fault event"
        seams = {d["seam"] for d in dumps}
        assert seams <= {"snapshot.restore", "guard.sync"}, seams
        if result.preemptions:
            assert "snapshot.restore" in seams
    finally:
        disarm_flight_recorder()
        set_telemetry_enabled(False)
        REGISTRY.reset()
        BUS.clear()


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(500, 508))
def test_serving_chaos_soak(seed):
    result = _run(seed, spec=ServingChaosSpec(wallclock_budget_s=60))
    assert result.elapsed_s < 60


@pytest.mark.slow
def test_serving_chaos_soak_heavy_schedule():
    """Longer schedule, more tenants, tighter queue: the soak variant that exercises backpressure mid-fault."""
    spec = ServingChaosSpec(
        n_steps=32, n_streams=8, batch_size=8, p_nan=0.3, p_preempt=0.25, queue_capacity=16
    )
    result = _run(510, spec=spec)
    assert result.acked >= spec.n_streams * (spec.n_steps - result.quarantined) / 2


def test_serving_chaos_soak_runner_aggregates():
    """The soak entry point runs every seed and reports per-seed results."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = run_serving_chaos_soak([0, 1], device="cpu")
    assert len(results) == 2
    assert all(r.ok for r in results), [r.describe() for r in results]
