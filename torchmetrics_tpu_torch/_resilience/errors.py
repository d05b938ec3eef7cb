"""Typed errors for the resilience subsystem (port of ``torchmetrics_tpu/_resilience/errors.py``).

All inherit :class:`TorchMetricsUserError` so existing ``except`` clauses over
the framework's user-error type keep working; the finer hierarchy lets callers
distinguish *transport* failures (retryable, degradable) from *structural* and
*integrity* failures (programming/persistence errors that must fail fast).
"""

from __future__ import annotations

from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


class GuardedSyncError(TorchMetricsUserError):
    """Base class for failures inside the guarded distributed-sync path."""


class CollectiveTimeoutError(GuardedSyncError):
    """One attempt of an eager collective exceeded the policy's timeout.

    The attempt's worker thread is abandoned (it may still be blocked inside
    the transport); the guard retries on a fresh worker or degrades.
    """


class SyncRetriesExhausted(GuardedSyncError):
    """Every attempt (initial + retries) of a guarded collective failed.

    Carries the attempt count and the last underlying error. Under the
    default ``on_exhausted="degrade"`` policy this never propagates to user
    code — the metric records a :class:`~torchmetrics_tpu_torch._resilience.policy.DegradationEvent`
    and continues with local-only state instead.
    """

    def __init__(self, message: str, attempts: int, last_error: BaseException | None = None):
        super().__init__(message)
        self.attempts = attempts
        self.last_error = last_error


class StateStructureMismatchError(TorchMetricsUserError):
    """The pre-collective handshake found differing state structures.

    Entering a collective with mismatched state trees (different state names,
    dtypes, shapes, or reductions across processes) would deadlock or
    silently mis-reduce; the handshake turns that into this immediate,
    diagnosable error. Never retried, never degraded: it indicates a
    programming/configuration error, not a transient fault.
    """


class SnapshotRestoreError(TorchMetricsUserError):
    """No snapshot generation could be restored.

    Raised by ``SnapshotManager.restore_latest`` when the snapshot directory
    holds no generation at all, or when every retained generation failed
    verification (file checksum, unpickling, or per-state integrity).
    Carries ``failures``: ``{generation: reason}`` for each attempt.
    """

    def __init__(self, message: str, failures: dict | None = None):
        super().__init__(message)
        self.failures = dict(failures or {})


class StateCorruptionError(TorchMetricsUserError):
    """A checkpoint failed integrity verification on restore.

    Raised by ``Metric.load_state_dict`` when a state's checksum does not
    match, the schema version is unknown, or a state recorded as finite at
    save time arrives NaN-poisoned. Pass ``strict="repair"`` to reset only
    the corrupted states and load the rest.
    """

    def __init__(self, message: str, corrupted: dict | None = None):
        super().__init__(message)
        self.corrupted = dict(corrupted or {})
