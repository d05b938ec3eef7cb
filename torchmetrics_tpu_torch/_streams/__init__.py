"""Multi-tenant vectorized metric streams (port of ``torchmetrics_tpu/_streams/``).

A :class:`StreamPool` holds N independent instances of one metric (or of
one ``MetricCollection``'s compute groups) as stacked states and drives any
micro-batch of them with one ``torch.func.vmap``-ped update step, a CUDA
graph per signature and capacity on the card. Per-stream lifecycle
(attach/detach/reset) is O(1), durability shards the snapshot journal per
stream (:class:`StreamSnapshotManager`), and telemetry gains a bounded
``stream=`` label dimension (:class:`StreamLabeler`).
"""

from torchmetrics_tpu_torch._streams.durability import StreamRestoreReport, StreamSnapshotManager
from torchmetrics_tpu_torch._streams.pool import (
    StreamPool,
    StreamPoolAdmissionError,
    StreamPoolUnsupported,
    memory_ceiling,
    set_memory_ceiling,
)
from torchmetrics_tpu_torch._streams.telemetry import StreamLabeler

__all__ = [
    "StreamLabeler",
    "StreamPool",
    "StreamPoolAdmissionError",
    "StreamPoolUnsupported",
    "StreamRestoreReport",
    "StreamSnapshotManager",
    "memory_ceiling",
    "set_memory_ceiling",
]
