"""Chaos soak harness: randomized fault schedules against real metrics.

Port of ``torchmetrics_tpu/_resilience/chaos.py``. The batches live on the
live target's device (the default factories take ``device=``, ``cuda``
unless given), and every check reads host copies of the states.

Each guard is proved in isolation by its own tests (one injected fault each). This
module proves the *composed* resilience stack: a seeded schedule interleaves
preemption kill/restore cycles, checkpoint corruption, NaN batch poisoning,
and transient collective failures/stalls into one metric stream, then checks
three invariants that must hold for every schedule:

1. **golden equality** — the final local state (and synced ``compute()``)
   equals a fault-free run over the same effective batch stream;
2. **idempotent restore+replay** — two successive fresh-process
   ``restore_latest()`` calls produce byte-identical state (and match the
   live stream's state);
3. **wall-clock budget** — the schedule finishes inside its budget: no
   guard may deadlock or retry unboundedly.

Every fault magnitude stays inside the stack's recovery envelope by
construction (collective failures below the retry budget, corruption only
when an older generation exists, preemptions only after the base snapshot),
because the claim under test is *recovery*, not data loss: a schedule the
stack is designed to survive must be survived exactly.

Determinism: all randomness flows from one ``numpy`` Generator seeded by the
schedule seed, and every fault acts at a batch boundary — re-running a seed
reproduces the schedule bit-for-bit (async snapshot writes may or may not
land before a kill, but the journal chain makes both outcomes restore to the
same state, so the invariants are race-free by design).
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch._observability import tracing as _tracing
from torchmetrics_tpu_torch._observability.events import BUS as _BUS
from torchmetrics_tpu_torch._resilience.faultinject import (
    corrupt_file,
    inject_collective_failure,
    inject_collective_timeout,
    poison_nans,
    simulated_world,
)
from torchmetrics_tpu_torch._resilience.integrity import to_host
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SnapshotPolicy, SyncPolicy
from torchmetrics_tpu_torch._resilience.snapshot import SnapshotManager, _SNAP_RE, _target_device

__all__ = [
    "ChaosSpec",
    "ChaosEvent",
    "ChaosResult",
    "run_chaos_schedule",
    "run_chaos_soak",
    "default_metric_factory",
    "default_collection_factory",
]


@dataclass(frozen=True)
class ChaosSpec:
    """Shape and fault mix of one chaos schedule (probabilities per batch)."""

    n_batches: int = 14
    batch_size: int = 8
    world_size: int = 2
    p_preempt: float = 0.25  # kill/restore after the batch commits
    p_corrupt_on_preempt: float = 0.5  # corrupt the newest snapshot before the kill
    p_nan: float = 0.2  # poison the batch's preds (quarantine must drop it)
    p_forward: float = 0.3  # drive the batch through forward() instead of update()
    final_collective_faults: int = 1  # transient failures injected into the final sync
    stall_final: bool = False  # stall (watchdog path) instead of raising
    snapshot_every_n: int = 3
    journal_max_entries: int = 8
    async_write: bool = True
    wallclock_budget_s: float = 10.0

    def __post_init__(self) -> None:
        if self.n_batches < 2:
            raise ValueError("a chaos schedule needs at least 2 batches")
        retry_budget = _SYNC_RETRIES  # transient faults must stay recoverable
        if self.final_collective_faults > retry_budget:
            raise ValueError(
                f"final_collective_faults={self.final_collective_faults} exceeds the retry budget"
                f" ({retry_budget}): the schedule would force degradation and golden equality"
                " could not hold"
            )


_SYNC_RETRIES = 2  # max_retries of the final sync's SyncPolicy (3 attempts total)


@dataclass(frozen=True)
class ChaosEvent:
    step: int
    kind: str  # "nan" | "forward" | "preempt" | "corrupt" | "restore" | "final_fault"
    detail: str = ""
    # correlation id of the batch's trace_context when tracing is enabled:
    # flight-recorder dumps for this fault must carry the same id
    trace_id: Optional[int] = None


@dataclass
class ChaosResult:
    """Outcome of one schedule; ``ok`` is the conjunction of the invariants."""

    seed: int
    elapsed_s: float
    events: List[ChaosEvent] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)
    golden_equal: bool = False
    restore_idempotent: bool = False
    within_budget: bool = False
    preemptions: int = 0
    replayed_total: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures and self.golden_equal and self.restore_idempotent and self.within_budget

    def describe(self) -> str:
        evs = ", ".join(f"{e.step}:{e.kind}" for e in self.events) or "no faults"
        status = "OK" if self.ok else "FAILED: " + "; ".join(self.failures)
        return (
            f"seed={self.seed} [{status}] {self.elapsed_s:.2f}s,"
            f" {self.preemptions} preemption(s), {self.replayed_total} replayed — {evs}"
        )


def default_metric_factory(device: Any = None) -> Any:
    """A mean-reduced regression metric with the NaN quarantine armed (on ``cuda`` unless ``device`` is given)."""
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    return MeanSquaredError(nan_policy="quarantine", device=device)


def default_collection_factory(device: Any = None) -> Any:
    """A two-member collection (distinct states, no compute-group merge)."""
    from torchmetrics_tpu_torch.collections import MetricCollection
    from torchmetrics_tpu_torch.regression import MeanAbsoluteError, MeanSquaredError

    return MetricCollection(
        [MeanSquaredError(nan_policy="quarantine", device=device), MeanAbsoluteError(nan_policy="quarantine", device=device)]
    )


def _local_state_blocks(target: Any) -> Dict[str, Any]:
    """Host-numpy snapshot of every state, keyed for comparison."""
    return target.state_dict(integrity=False, all_states=True, _host=True)


def _states_allclose(a: Dict[str, Any], b: Dict[str, Any], exact: bool = False) -> Tuple[bool, str]:
    if a.keys() != b.keys():
        return False, f"state keys differ: {sorted(a)} vs {sorted(b)}"
    for key in a:
        xs = a[key] if isinstance(a[key], list) else [a[key]]
        ys = b[key] if isinstance(b[key], list) else [b[key]]
        if len(xs) != len(ys):
            return False, f"state `{key}`: chunk counts differ ({len(xs)} vs {len(ys)})"
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape:
                return False, f"state `{key}`: shapes differ ({x.shape} vs {y.shape})"
            same = np.array_equal(x, y) if exact else np.allclose(x, y, rtol=1e-5, atol=1e-6)
            if not same:
                return False, f"state `{key}`: values diverge (max abs diff {np.abs(x - y).max()})"
    return True, ""


def _values_allclose(a: Any, b: Any) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_values_allclose(a[k], b[k]) for k in a)
    a, b = (to_host(v) if isinstance(v, torch.Tensor) else np.asarray(v) for v in (a, b))
    return bool(np.allclose(a, b, rtol=1e-5, atol=1e-6))


def run_chaos_schedule(
    seed: int,
    factory: Optional[Callable[[], Any]] = None,
    directory: Optional[Union[str, Path]] = None,
    spec: Optional[ChaosSpec] = None,
) -> ChaosResult:
    """Run one seeded fault schedule and check the three invariants.

    ``factory`` builds a *fresh* target (metric or collection) — it is
    called for the live stream, for the fault-free golden, once per
    simulated preemption, and twice for the idempotence check, so it must
    return identically-configured instances every time. The batches are
    made on the live target's device.
    """
    spec = spec or ChaosSpec()
    factory = factory or default_metric_factory
    rng = np.random.default_rng(seed)
    tmp_ctx = None
    if directory is None:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="tm_chaos_")
        directory = tmp_ctx.name
    directory = Path(directory)

    result = ChaosResult(seed=seed, elapsed_s=0.0)
    t0 = time.perf_counter()
    try:
        _run_schedule(seed, factory, directory, spec, rng, result)
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


def _policy(spec: ChaosSpec) -> SnapshotPolicy:
    return SnapshotPolicy(
        every_n_updates=spec.snapshot_every_n,
        every_seconds=None,
        keep=2,
        journal_max_entries=spec.journal_max_entries,
        async_write=spec.async_write,
    )


def _snapshots_on_disk(directory: Path) -> List[Path]:
    return sorted(p for p in directory.iterdir() if _SNAP_RE.match(p.name))


def _run_schedule(
    seed: int,
    factory: Callable[[], Any],
    directory: Path,
    spec: ChaosSpec,
    rng: np.random.Generator,
    result: ChaosResult,
) -> None:
    # -------------------------------------------------- schedule (pre-drawn)
    batches = [
        (
            rng.normal(size=spec.batch_size).astype(np.float32),
            rng.normal(size=spec.batch_size).astype(np.float32),
        )
        for _ in range(spec.n_batches)
    ]
    poisoned = [rng.random() < spec.p_nan for _ in range(spec.n_batches)]
    use_forward = [rng.random() < spec.p_forward for _ in range(spec.n_batches)]
    # no preemption after the last batch (nothing left to prove) and none
    # before the base snapshot exists (step 0 always commits first)
    preempt = [0 < i < spec.n_batches - 1 and rng.random() < spec.p_preempt for i in range(spec.n_batches)]
    corrupt_roll = [rng.random() < spec.p_corrupt_on_preempt for _ in range(spec.n_batches)]

    # ------------------------------------------------------------ live stream
    live = factory()
    device = _target_device(live)
    batches = [(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)) for p, t in batches]
    mgr = SnapshotManager(live, directory, _policy(spec))
    corrupted: set = set()  # generations this schedule already destroyed
    try:
        for i, (preds, target) in enumerate(batches):
            # one trace context per batch: the injected faults below fire
            # inside it, so flight-recorder dumps carry the failing batch's
            # correlation id (no-op while tracing is disabled)
            with _tracing.trace_context(f"chaos_batch_{i}", "chaos", step=i):
                tid = _tracing.current_trace_id()
                p = poison_nans(preds, frac=0.5) if poisoned[i] else preds
                t = target
                if poisoned[i]:
                    # the quarantine degradation the poisoned batch provokes is
                    # itself a flight-recorder trigger — no extra event needed
                    result.events.append(ChaosEvent(i, "nan", trace_id=tid))
                if use_forward[i]:
                    live.forward(p, t)
                else:
                    live.update(p, t)
                if preempt[i]:
                    if corrupt_roll[i]:
                        # the corrupt fault models at-rest storage damage to a fully
                        # written snapshot, so quiesce pending writes+prunes first
                        # (the race being dodged is in the injector's bookkeeping,
                        # not in the stack under test), then stay inside the
                        # recovery envelope: both survivors of the retention window
                        # must be valid — prune retains by count, so a previously
                        # corrupted generation can occupy the fallback slot
                        mgr.flush()
                        snaps = _snapshots_on_disk(directory)
                        window = snaps[-2:]
                        if len(window) >= 2 and all(s.name not in corrupted for s in window):
                            corrupt_file(window[-1], "bitflip", seed=seed * 1000 + i)
                            corrupted.add(window[-1].name)
                            # corruption surfaces as the restore's fallback
                            # degradation (its own trigger), so no chaos_fault
                            result.events.append(
                                ChaosEvent(i, "corrupt", window[-1].name, trace_id=tid)
                            )
                    mgr.simulate_preemption()
                    # a clean kill+restore produces NO degradation — name the
                    # fault on the bus so the flight recorder still dumps it
                    _BUS.publish(
                        "chaos_fault", type(live).__name__,
                        f"preemption kill at batch {i}",
                        data={"seam": "snapshot.restore", "fault": "preemption", "step": i},
                    )
                    result.events.append(ChaosEvent(i, "preempt", trace_id=tid))
                    result.preemptions += 1
                    live = factory()
                    mgr = SnapshotManager(live, directory, _policy(spec))
                    report = mgr.restore_latest()
                    result.replayed_total += report.replayed
                    result.events.append(
                        ChaosEvent(
                            i, "restore",
                            f"gen={report.generation} replayed={report.replayed}",
                            trace_id=tid,
                        )
                    )
                    if report.truncated_journal:
                        result.failures.append(
                            f"step {i}: restore truncated the journal (entries lost)"
                        )
    finally:
        # a raising schedule must not leak the writer thread / journal fd
        # (close() is idempotent, so the happy path pays nothing extra)
        mgr.close()
    if mgr.last_error is not None:
        result.failures.append(f"snapshot writer error: {mgr.last_error}")

    # -------------------------------------------------------------- golden
    golden = factory()
    for i, (preds, target) in enumerate(batches):
        if poisoned[i]:
            continue  # quarantine drops these batches from the live stream
        golden.update(preds, target)

    ok, why = _states_allclose(_local_state_blocks(live), _local_state_blocks(golden))
    if not ok:
        result.failures.append(f"live state diverged from fault-free golden: {why}")

    # -------------------------------------------- idempotent restore+replay
    r1, r2 = factory(), factory()
    # own trace contexts: these restores re-walk any corrupted generation, so
    # their fallback degradations (flight triggers) stay correlated
    with _tracing.trace_context("chaos_restore_check", "chaos"):
        with SnapshotManager(r1, directory, _policy(spec)) as m1:
            m1.restore_latest()
        with SnapshotManager(r2, directory, _policy(spec)) as m2:
            m2.restore_latest()
    exact, why = _states_allclose(_local_state_blocks(r1), _local_state_blocks(r2), exact=True)
    if not exact:
        result.failures.append(f"restore+replay not idempotent: {why}")
    close_live, why = _states_allclose(_local_state_blocks(r1), _local_state_blocks(live))
    if not close_live:
        result.failures.append(f"restored state diverged from the live stream: {why}")
    result.restore_idempotent = exact and close_live

    # ------------------------------- final synced compute under live faults
    retry = RetryPolicy(max_retries=_SYNC_RETRIES, backoff_base=0.01, backoff_max=0.05,
                        timeout=0.5 if spec.stall_final else None)
    sync_policy = SyncPolicy(retry=retry)
    live.set_resilience_policy(sync_policy=sync_policy)
    golden.set_resilience_policy(sync_policy=sync_policy)
    with simulated_world(spec.world_size):
        golden_value = golden.compute()
        if spec.final_collective_faults:
            injector = (
                inject_collective_timeout(first_n=spec.final_collective_faults, hang=30.0)
                if spec.stall_final
                else inject_collective_failure(first_n=spec.final_collective_faults)
            )
            with _tracing.trace_context("chaos_final_sync", "chaos"):
                tid = _tracing.current_trace_id()
                with injector as stats:
                    live_value = live.compute()
                # transient collective faults are absorbed by the retry budget
                # (that is the invariant under test) and so produce no
                # degradation — name each on the bus for the flight recorder
                fault_name = "collective_stall" if spec.stall_final else "collective_failure"
                for k in range(stats.injected):
                    _BUS.publish(
                        "chaos_fault", type(live).__name__,
                        f"{fault_name} {k + 1}/{stats.injected} during final sync",
                        data={"seam": "guard.sync", "fault": fault_name},
                    )
            result.events.append(
                ChaosEvent(spec.n_batches, "final_fault",
                           f"{'stall' if spec.stall_final else 'failure'} x{stats.injected}",
                           trace_id=tid)
            )
        else:
            live_value = live.compute()
    values_ok = _values_allclose(live_value, golden_value)
    result.golden_equal = ok and values_ok
    if not values_ok:
        result.failures.append(
            f"final synced compute diverged from golden: {live_value!r} vs {golden_value!r}"
        )


def run_chaos_soak(
    seeds: Any,
    factory: Optional[Callable[[], Any]] = None,
    spec: Optional[ChaosSpec] = None,
) -> List[ChaosResult]:
    """Run many seeded schedules; returns every result (callers assert ``ok``)."""
    return [run_chaos_schedule(int(s), factory=factory, spec=spec) for s in seeds]
