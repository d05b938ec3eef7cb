"""Fault-tolerant metric runtime: guarded sync, state integrity, fault injection.

Port of ``torchmetrics_tpu/_resilience``: the same modules and the same
``__all__``, over ``torch.distributed`` and tensors that stay on their device.

Three hardened seams:

1. **Guarded distributed sync** — attach a :class:`SyncPolicy` to any metric
   (``Metric(sync_policy=...)``, ``Metric.set_resilience_policy``, or the
   process-wide :func:`set_default_sync_policy`) and the eager multi-process
   sync gains a pre-collective structure handshake, per-attempt timeouts,
   retry with exponential backoff, and graceful degradation to local-only
   compute with a recorded :class:`DegradationEvent`
   (``Metric.resilience_report()``).
2. **State integrity** — ``Metric.state_dict(..., integrity=True)`` attaches
   checksummed, versioned metadata; ``load_state_dict`` verifies it, rejects
   corrupt/NaN-poisoned restores with :class:`StateCorruptionError`, and
   ``strict="repair"`` resets only the corrupted states. The ``nan_policy``
   constructor knob (``"raise"``/``"warn"``/``"quarantine"``) guards live
   updates against NaN/Inf poisoning.
3. **Fault injection** — :mod:`torchmetrics_tpu_torch._resilience.faultinject`
   deterministically injects collective failures, stalls, corrupted
   checkpoints, and NaN batches through the same seams production traffic
   uses, backing ``tests/test_torch_resilience_*.py``.
"""

from torchmetrics_tpu_torch._resilience.errors import (
    CollectiveTimeoutError,
    GuardedSyncError,
    SnapshotRestoreError,
    StateCorruptionError,
    StateStructureMismatchError,
    SyncRetriesExhausted,
)
from torchmetrics_tpu_torch._resilience.guard import run_guarded, state_structure_digest
from torchmetrics_tpu_torch._resilience.integrity import INTEGRITY_VERSION, integrity_key, nonfinite_state_report
from torchmetrics_tpu_torch._resilience.policy import (
    NAN_POLICIES,
    DegradationEvent,
    ResilienceReport,
    RetryPolicy,
    SnapshotPolicy,
    SyncPolicy,
    default_sync_policy,
    set_default_sync_policy,
)
from torchmetrics_tpu_torch._resilience.snapshot import SNAPSHOT_VERSION, RestoreReport, SnapshotManager

__all__ = [
    "CollectiveTimeoutError",
    "DegradationEvent",
    "GuardedSyncError",
    "INTEGRITY_VERSION",
    "NAN_POLICIES",
    "ResilienceReport",
    "RestoreReport",
    "RetryPolicy",
    "SNAPSHOT_VERSION",
    "SnapshotManager",
    "SnapshotPolicy",
    "SnapshotRestoreError",
    "StateCorruptionError",
    "StateStructureMismatchError",
    "SyncPolicy",
    "SyncRetriesExhausted",
    "default_sync_policy",
    "integrity_key",
    "nonfinite_state_report",
    "run_guarded",
    "set_default_sync_policy",
    "state_structure_digest",
]
