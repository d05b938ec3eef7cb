"""The SPMD engine: update, sync over the mesh rows and compute in one step (port of ``torchmetrics_tpu/_spmd/``).

Metric states live stacked over the rows of a named 1-D mesh (``(D, *s)``
tensors, one row a mesh position); ``step(global_batch)`` runs each row's
update on its shard of the batch under ``torch.func.vmap``, syncs the rows
by each state's declared ``dist_reduce_fx`` (``utilities.distributed.sync_in_jit``)
and computes, one CUDA graph a key on the card. Gated by the eligibility
copy's ``in_graph_sync`` facet; wrapped by the resilience handshake and
degradation; observable through the telemetry registry; durable through the
SnapshotManager's boundary host copies. Across cards, one process a card:
``build_mesh(devices, process_group=...)`` and the sync's collectives over
the group, captured into the step's graph on NCCL.

Entry points: :class:`SpmdEngine`, or ``Metric.to_spmd()`` /
``MetricCollection.to_spmd()``.
"""

from torchmetrics_tpu_torch._spmd.engine import SpmdEngine
from torchmetrics_tpu_torch._spmd.specs import (
    COLLECTIVE_FOR,
    InGraphSyncUnsupported,
    build_mesh,
    state_specs,
    sync_plan,
    validate_reductions,
)

__all__ = [
    "COLLECTIVE_FOR",
    "InGraphSyncUnsupported",
    "SpmdEngine",
    "build_mesh",
    "state_specs",
    "sync_plan",
    "validate_reductions",
]
