"""Resilience policy objects, degradation events, and reports.

Port of ``torchmetrics_tpu/_resilience/policy.py``: the same pure-Python
dataclasses under the same names.

The policy objects are small frozen dataclasses so they are hashable,
picklable, and safe to share between metrics. A ``SyncPolicy`` attached to a
metric (``Metric(sync_policy=...)`` / ``Metric.set_resilience_policy``) turns
on the guarded eager-sync path: pre-collective structure handshake, per-attempt
timeout, retry with exponential backoff, and — on exhaustion — graceful
degradation to local-only compute with a recorded :class:`DegradationEvent`.

With no policy attached (the default), ``Metric.sync`` behaves exactly as
before this subsystem existed: zero added work, zero behavior change.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = [
    "RetryPolicy",
    "SyncPolicy",
    "SnapshotPolicy",
    "DegradationEvent",
    "ResilienceReport",
    "NAN_POLICIES",
    "default_sync_policy",
    "set_default_sync_policy",
]

# knob values for Metric(nan_policy=...): None disables the sentinel guard
NAN_POLICIES = (None, "raise", "warn", "quarantine")

# cap of the per-metric degradation-event log (older events are evicted and
# counted in ResilienceReport.dropped_events)
MAX_EVENTS = 64


@dataclass(frozen=True)
class RetryPolicy:
    """Timeout/retry/backoff schedule for one guarded collective.

    ``timeout`` is per attempt, in seconds. ``None`` (the default) runs
    attempts inline: retries, backoff, and degradation still apply to every
    *raised* transport error, but a transport that blocks forever blocks the
    caller. Setting a timeout arms the watchdog: each attempt then runs on a
    daemon worker thread and is abandoned at the deadline — full hang
    protection, at the cost of one cross-thread dispatch per sync (~100µs
    class; container schedulers that throttle secondary threads can inflate
    this, which is why it is opt-in rather than the default).

    ``max_retries`` counts attempts *after* the first, so ``max_retries=2``
    means up to three attempts total. Backoff before retry ``k`` (0-based)
    sleeps ``min(backoff_max, backoff_base * backoff_factor**k)`` seconds.
    """

    max_retries: int = 2
    timeout: Optional[float] = None
    backoff_base: float = 0.5
    backoff_factor: float = 2.0
    backoff_max: float = 30.0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"`max_retries` must be >= 0, got {self.max_retries}")
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError(f"`timeout` must be positive or None, got {self.timeout}")
        if self.backoff_base < 0 or self.backoff_factor < 1.0 or self.backoff_max < 0:
            raise ValueError(
                "backoff schedule requires backoff_base >= 0, backoff_factor >= 1, backoff_max >= 0;"
                f" got base={self.backoff_base}, factor={self.backoff_factor}, max={self.backoff_max}"
            )

    @property
    def attempts(self) -> int:
        return self.max_retries + 1

    def backoff(self, retry_index: int) -> float:
        """Sleep duration before retry ``retry_index`` (0-based)."""
        return min(self.backoff_max, self.backoff_base * self.backoff_factor**retry_index)


@dataclass(frozen=True)
class SyncPolicy:
    """Full guarded-sync configuration for ``Metric.sync``.

    - ``retry``: the per-collective :class:`RetryPolicy`.
    - ``handshake``: exchange a structure digest (state names, dtypes,
      shapes, reductions) via one cheap scalar all-gather before the real
      collective, so mismatched state trees fail fast with a diagnostic
      instead of deadlocking. After the first success the handshake is
      skipped while the local structure is unchanged — sound as long as
      every process takes the same code path (the skip decision is local, so
      one rank mutating its structure mid-stream while peers do not would
      desync collective counts; that is already a broken program, but set
      ``handshake_every_sync=True`` to re-verify before every collective —
      one extra scalar all-gather per sync — and keep the fail-fast
      diagnostic even for that case).
    - ``on_exhausted``: ``"degrade"`` (default) falls back to local-only
      compute and records a :class:`DegradationEvent` on the metric;
      ``"raise"`` propagates :class:`~torchmetrics_tpu_torch._resilience.errors.SyncRetriesExhausted`.
    """

    retry: RetryPolicy = field(default_factory=RetryPolicy)
    handshake: bool = True
    handshake_every_sync: bool = False
    on_exhausted: str = "degrade"

    def __post_init__(self) -> None:
        if self.on_exhausted not in ("degrade", "raise"):
            raise ValueError(f"`on_exhausted` must be 'degrade' or 'raise', got {self.on_exhausted!r}")


@dataclass(frozen=True)
class SnapshotPolicy:
    """Cadence/durability configuration for a :class:`~torchmetrics_tpu_torch._resilience.snapshot.SnapshotManager`.

    A snapshot is taken whenever any armed trigger fires, evaluated at
    update boundaries (there is no timer thread — an idle metric is not
    re-snapshotted): after ``every_n_updates`` journaled updates, after
    ``every_seconds`` of wall clock since the last snapshot, or when the
    post-snapshot journal reaches ``journal_max_entries`` (the journal bound
    that keeps restore replay small). ``keep`` is the number of snapshot
    generations retained for corruption fallback (journals are kept for
    every retained generation, so a lost/corrupt newest snapshot is bridged
    by replaying the older generation's journal chain).

    ``async_write`` serializes state inline (a consistent capture on the
    caller's thread) but performs the write+fsync+rename on a background
    daemon writer; a crash before the write lands is covered by the journal
    chain. ``fsync_journal`` additionally fsyncs after every journal entry:
    per-entry flush (the default) already survives process death —
    preemption kills the process, not the kernel — while fsync extends
    durability to machine crashes at a per-update IO cost.
    """

    every_n_updates: Optional[int] = None
    every_seconds: Optional[float] = 30.0
    keep: int = 2
    journal_max_entries: int = 256
    async_write: bool = True
    fsync_journal: bool = False

    def __post_init__(self) -> None:
        if self.every_n_updates is not None and self.every_n_updates < 1:
            raise ValueError(f"`every_n_updates` must be >= 1 or None, got {self.every_n_updates}")
        if self.every_seconds is not None and self.every_seconds <= 0:
            raise ValueError(f"`every_seconds` must be positive or None, got {self.every_seconds}")
        if self.keep < 1:
            raise ValueError(f"`keep` must be >= 1, got {self.keep}")
        if self.keep < 2:
            import warnings

            warnings.warn(
                "SnapshotPolicy(keep=1) leaves no older generation to fall back to when the"
                " newest snapshot is corrupted; keep >= 2 is strongly recommended.",
                stacklevel=3,
            )
        if self.journal_max_entries < 1:
            raise ValueError(f"`journal_max_entries` must be >= 1, got {self.journal_max_entries}")


@dataclass(frozen=True)
class DegradationEvent:
    """One recorded degradation on a metric (queryable via ``resilience_report``).

    ``kind`` is a stable short string: ``"sync_degraded"`` (collective
    retries exhausted, local-only compute), ``"handshake_degraded"``
    (handshake transport failed, local-only compute), ``"nan_quarantine"``
    (a batch's state contribution was rolled back by the NaN sentinel),
    ``"state_repair"`` (``load_state_dict(strict="repair")`` reset corrupted
    states), ``"snapshot_degraded"`` (the attached SnapshotManager hit an
    IO error and disabled itself), ``"snapshot_restore"``
    (``restore_latest`` fell back past a corrupted generation or a
    truncated journal), ``"fleet_partial"`` (a fleet rollup's fan-in
    deadline expired with children missing — partial rollup, stragglers
    fold late), ``"fleet_corrupt"`` (a fleet contribution failed
    integrity verification at fold time and was quarantined), or
    ``"fleet_publish_degraded"`` (a fleet publish exhausted its retries;
    the delta was retained to ride the next epoch).
    """

    kind: str
    metric: str
    detail: str
    attempts: int = 0
    timestamp: float = field(default_factory=time.time)


@dataclass(frozen=True)
class ResilienceReport:
    """Aggregate resilience telemetry for one metric instance.

    ``events`` holds the most recent :data:`MAX_EVENTS` degradations;
    ``dropped_events`` counts older ones evicted from the capped log (a
    permanently-degraded long-running job must not leak memory one event
    per sync).
    """

    metric: str
    events: Tuple[DegradationEvent, ...]
    quarantined_updates: int
    dropped_events: int = 0

    @property
    def degraded_syncs(self) -> int:
        return sum(1 for e in self.events if e.kind in ("sync_degraded", "handshake_degraded"))

    @property
    def healthy(self) -> bool:
        """True when no degradation of any kind has been recorded."""
        return not self.events and self.quarantined_updates == 0


# ---------------------------------------------------------------------------
# process-wide default sync policy (opt-in; None keeps the legacy fast path)
# ---------------------------------------------------------------------------

_default_sync_policy: Optional[SyncPolicy] = None


def default_sync_policy() -> Optional[SyncPolicy]:
    """The process-wide ``SyncPolicy`` used by metrics without their own."""
    return _default_sync_policy


def set_default_sync_policy(policy: Optional[SyncPolicy]) -> None:
    """Install a process-wide default guarded-sync policy (``None`` disables)."""
    global _default_sync_policy
    if policy is not None and not isinstance(policy, SyncPolicy):
        raise ValueError(f"Expected a `SyncPolicy` or None, got {policy!r}")
    _default_sync_policy = policy
