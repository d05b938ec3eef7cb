"""Chaos under load: the resilience fault schedules fired at a LIVE server.

Port of ``torchmetrics_tpu/_serving/chaos.py``, over the port's
``_resilience.faultinject`` and ``policy``; the default factories take
``device=`` (``cuda`` unless given).

Resilience claims proven at rest are not production claims — a preemption
that restores cleanly between requests says nothing about one that lands
while the ingress queue is half full and clients hold unresolved acks.
This module re-runs the existing fault inventory (NaN batch poisoning,
preemption kill/restore through the stream-sharded journal, transient
collective faults) *while a* :class:`~torchmetrics_tpu_torch._serving.runtime.
MetricServer` *ingests*, and checks the serving-grade invariants:

1. **Golden equality over acknowledged rows** — every tenant's final
   ``compute`` equals an eager replica fed exactly the acked,
   non-quarantined rows, in ack order. Faults may reject, quarantine, or
   delay; they may not corrupt or lose an acknowledged row.
2. **No lost acknowledged batches** — a preemption after an ack must
   replay that row from the journal; requests in flight at the kill are
   resumed (or remain pending) but never silently dropped.
3. **Bounded recovery** — each kill/restore cycle completes inside
   ``recovery_budget_ms`` (``ServingChaosResult.describe`` reports the
   p50 over these cycles).
4. **One flight dump per fault** — each ``chaos_fault`` / ``load_shed``
   trigger freezes exactly one post-mortem dump (dedup by bus seq).
5. **Wall-clock budget** — the whole schedule finishes inside
   ``wallclock_budget_s``: a wedged server costs one seed, not the run.

Determinism: all randomness is pre-drawn from one seeded ``numpy``
Generator, and every fault fires at a *batch-boundary barrier* (all
outstanding acks resolved first) — re-running a seed reproduces the
schedule bit-for-bit.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

import torch

from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._resilience.faultinject import (
    inject_collective_failure,
    poison_nans,
    simulated_world,
)
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SnapshotPolicy, SyncPolicy
from torchmetrics_tpu_torch._serving.controller import ControllerConfig
from torchmetrics_tpu_torch._serving.requests import BackpressureError
from torchmetrics_tpu_torch._serving.runtime import MetricServer

__all__ = [
    "ServingChaosSpec",
    "ServingChaosResult",
    "run_serving_chaos",
    "run_serving_chaos_soak",
    "default_serving_factory",
]

_SYNC_RETRIES = 2  # transient collective faults must stay inside the retry budget


@dataclass(frozen=True)
class ServingChaosSpec:
    """Shape and fault mix of one serving chaos schedule."""

    n_steps: int = 16  # submission rounds
    n_streams: int = 4  # concurrent tenants
    batch_size: int = 8  # rows per request
    p_nan: float = 0.2  # poison one request's preds this round
    p_preempt: float = 0.2  # kill/recover at this round's barrier
    collective_faults: int = 1  # transient failures during a mid-load guarded sync
    world_size: int = 2
    queue_capacity: int = 64
    ack_timeout_s: float = 30.0
    recovery_budget_ms: float = 30_000.0
    wallclock_budget_s: float = 120.0
    snapshot_every_n: int = 4
    journal_max_entries: int = 64

    def __post_init__(self) -> None:
        if self.n_steps < 3:
            raise ValueError("a serving chaos schedule needs at least 3 steps")
        if self.collective_faults > _SYNC_RETRIES:
            raise ValueError(
                f"collective_faults={self.collective_faults} exceeds the retry budget"
                f" ({_SYNC_RETRIES}): the sync would degrade and golden equality break"
            )


@dataclass
class ServingChaosResult:
    """Outcome of one schedule; ``ok`` is the conjunction of the invariants."""

    seed: int
    elapsed_s: float = 0.0
    failures: List[str] = field(default_factory=list)
    events: List[Tuple[int, str]] = field(default_factory=list)  # (step, kind)
    golden_equal: bool = False
    within_budget: bool = False
    preemptions: int = 0
    recovery_ms: List[float] = field(default_factory=list)
    acked: int = 0
    quarantined: int = 0
    rejected: int = 0
    fault_events: int = 0  # chaos_fault publishes (flight-dump expectation)

    @property
    def ok(self) -> bool:
        return not self.failures and self.golden_equal and self.within_budget

    def describe(self) -> str:
        evs = ", ".join(f"{s}:{k}" for s, k in self.events) or "no faults"
        status = "OK" if self.ok else "FAILED: " + "; ".join(self.failures)
        rec = (
            f" recovery p50 {sorted(self.recovery_ms)[len(self.recovery_ms) // 2]:.0f}ms"
            if self.recovery_ms
            else ""
        )
        return (
            f"seed={self.seed} [{status}] {self.elapsed_s:.2f}s, {self.preemptions}"
            f" preemption(s),{rec} {self.acked} acked / {self.quarantined} quarantined — {evs}"
        )


def default_serving_factory(device: Optional[Any] = None) -> Any:
    """The chaos template: mean-squared error with the NaN quarantine armed (on ``device``, ``cuda`` unless given)."""
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    return MeanSquaredError(nan_policy="quarantine", device=device)


def _eager_factory(device: Optional[Any] = None) -> Any:
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    return MeanSquaredError(device=device)


def run_serving_chaos(
    seed: int,
    directory: Optional[Union[str, Path]] = None,
    spec: Optional[ServingChaosSpec] = None,
    factory: Optional[Callable[[], Any]] = None,
    eager_factory: Optional[Callable[[], Any]] = None,
    device: Optional[Any] = None,
) -> ServingChaosResult:
    """Run one seeded chaos-under-load schedule against a live server.

    ``device`` places the default factories' metrics (``cuda`` unless given);
    factories passed in place their own.
    """
    spec = spec or ServingChaosSpec()
    factory = factory or (lambda: default_serving_factory(device))
    eager_factory = eager_factory or (lambda: _eager_factory(device))
    tmp_ctx = None
    if directory is None:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="tm_serving_chaos_")
        directory = tmp_ctx.name
    result = ServingChaosResult(seed=seed)
    t0 = time.perf_counter()
    try:
        _run_schedule(seed, Path(directory), spec, factory, eager_factory, result)
    except Exception as err:  # noqa: BLE001 - a crash IS an invariant failure
        result.failures.append(f"schedule raised {type(err).__name__}: {err}")
    finally:
        result.elapsed_s = time.perf_counter() - t0
        result.within_budget = result.elapsed_s <= spec.wallclock_budget_s
        if not result.within_budget:
            result.failures.append(
                f"wall-clock budget exceeded: {result.elapsed_s:.2f}s > {spec.wallclock_budget_s}s"
            )
        if tmp_ctx is not None:
            tmp_ctx.cleanup()
    return result


def _run_schedule(
    seed: int,
    directory: Path,
    spec: ServingChaosSpec,
    factory: Callable[[], Any],
    eager_factory: Callable[[], Any],
    result: ServingChaosResult,
) -> None:
    rng = np.random.default_rng(seed)
    # ---------------------------------------------------- schedule (pre-drawn)
    batches = [
        [
            (
                rng.normal(size=spec.batch_size).astype(np.float32),
                rng.normal(size=spec.batch_size).astype(np.float32),
            )
            for _ in range(spec.n_streams)
        ]
        for _ in range(spec.n_steps)
    ]
    nan_step = [rng.random() < spec.p_nan for _ in range(spec.n_steps)]
    nan_victim = [int(rng.integers(spec.n_streams)) for _ in range(spec.n_steps)]
    # no preemption at step 0 (base snapshot must exist) or the last step
    preempt = [
        0 < i < spec.n_steps - 1 and rng.random() < spec.p_preempt for i in range(spec.n_steps)
    ]
    sync_step = spec.n_steps // 2  # the mid-load guarded sync with collective faults

    server = MetricServer(
        factory(),
        capacity=spec.n_streams,
        queue_capacity=spec.queue_capacity,
        controller=ControllerConfig(max_batch=max(4, spec.n_streams)),
        snapshot_dir=directory,
        snapshot_policy=SnapshotPolicy(
            every_n_updates=spec.snapshot_every_n,
            journal_max_entries=spec.journal_max_entries,
            async_write=False,
        ),
    )
    sids = [server.attach_stream() for _ in range(spec.n_streams)]
    # eager replicas accumulate exactly the acked, non-quarantined rows
    goldens: Dict[int, Any] = {sid: eager_factory() for sid in sids}
    golden_rows: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {sid: [] for sid in sids}
    server.warm(batches[0][0][0], batches[0][0][1])
    server.start()
    try:
        for step in range(spec.n_steps):
            acks = []
            for lane, sid in enumerate(sids):
                preds, target = batches[step][lane]
                if nan_step[step] and lane == nan_victim[step]:
                    preds = poison_nans(preds, frac=0.5).numpy()
                    result.events.append((step, "nan"))
                try:
                    ack = server.submit(sid, preds, target)
                except BackpressureError:
                    result.rejected += 1
                    continue
                acks.append((sid, preds, target, ack))
            # batch-boundary barrier: every fault below fires with no ack
            # outstanding, so re-running a seed reproduces the schedule
            for sid, preds, target, ack in acks:
                if not ack.wait(spec.ack_timeout_s):
                    result.failures.append(f"step {step}: ack for stream {sid} timed out")
                    return
                if ack.acked:
                    result.acked += 1
                    if ack.quarantined:
                        result.quarantined += 1
                    else:
                        golden_rows[sid].append((preds, target))
                else:
                    result.failures.append(
                        f"step {step}: stream {sid} request failed: {ack.state}"
                    )
            if step == sync_step and spec.collective_faults:
                # a transient collective fault during a guarded sync, WHILE
                # the server keeps ingesting other tenants: the retry budget
                # absorbs it and serving traffic never notices
                mirror = eager_factory()
                mirror.set_resilience_policy(
                    sync_policy=SyncPolicy(
                        retry=RetryPolicy(
                            max_retries=_SYNC_RETRIES, backoff_base=0.01, backoff_max=0.05
                        )
                    )
                )
                rows = golden_rows[sids[0]]
                if rows:
                    for p, t in rows:
                        mirror.update(*_on(mirror, p, t))
                    with simulated_world(spec.world_size):
                        with inject_collective_failure(first_n=spec.collective_faults) as stats:
                            mirror.compute()
                    for k in range(stats.injected):
                        _BUS.publish(
                            "chaos_fault",
                            "MetricServer",
                            f"collective_failure {k + 1}/{stats.injected} during"
                            " mid-load guarded sync",
                            data={"seam": "guard.sync", "fault": "collective_failure"},
                        )
                        result.fault_events += 1
                    result.events.append((step, "collective"))
            if preempt[step]:
                t_kill = time.perf_counter()
                server.simulate_preemption()
                _BUS.publish(
                    "chaos_fault",
                    "MetricServer",
                    f"preemption kill at step {step} (queue depth {server.queue.depth})",
                    data={"seam": "snapshot.restore", "fault": "preemption", "step": step},
                )
                result.fault_events += 1
                report, recovery_ms = server.recover()
                # recovery covers kill-to-serving, as a client would see it
                recovery_ms = (time.perf_counter() - t_kill) * 1000.0
                result.recovery_ms.append(recovery_ms)
                result.preemptions += 1
                result.events.append((step, "preempt"))
                if report.truncated_journal:
                    result.failures.append(f"step {step}: restore truncated the journal")
                if recovery_ms > spec.recovery_budget_ms:
                    result.failures.append(
                        f"step {step}: recovery took {recovery_ms:.0f}ms"
                        f" > budget {spec.recovery_budget_ms:.0f}ms"
                    )
    finally:
        server.close()

    # ------------------------------------------------- golden equality check
    equal = True
    for sid in sids:
        if not golden_rows[sid]:
            continue
        for p, t in golden_rows[sid]:
            goldens[sid].update(*_on(goldens[sid], p, t))
        want = goldens[sid].compute().cpu().numpy()
        # the server is closed; read the final value straight off the pool
        got = server.pool.compute(sid).cpu().numpy()
        if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
            equal = False
            result.failures.append(
                f"stream {sid}: served value {got!r} diverged from acked-rows golden {want!r}"
            )
    result.golden_equal = equal


def _on(metric: Any, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """Host arrays as tensors on ``metric``'s device."""
    return tuple(torch.as_tensor(a, device=metric.device) for a in arrays)


def run_serving_chaos_soak(
    seeds: Any,
    spec: Optional[ServingChaosSpec] = None,
    device: Optional[Any] = None,
) -> List[ServingChaosResult]:
    """Run many seeded schedules; callers assert ``ok`` per result."""
    return [run_serving_chaos(int(s), spec=spec, device=device) for s in seeds]
