"""Fault-tolerant hierarchical fleet aggregation: edge -> region -> global.

Port of ``torchmetrics_tpu/_fleet/`` (the same seven modules and 17 names).
This package rolls per-host metric state up an N-level tree over a
key-value rendezvous transport, with the failure semantics a fleet
actually needs:

- **straggler degradation**: per-level fan-in deadlines; children that
  miss the deadline are degraded (partial rollup + ``fleet_partial``
  degradation event + flight dump), never awaited, and their late
  contributions fold into a subsequent epoch;
- **epoch fencing**: contribution keys carry ``(node_id, epoch,
  state_digest)``; the fold ledger plus a sliding watermark turn
  at-least-once delivery into exactly-once folding (zombie replicas
  cannot double-contribute);
- **integrity at every hop**: contributions ship host copies of
  ``state_dict(integrity=True)`` behind an outer checksum; corrupt payloads
  are quarantined (``fleet_corrupt``), never folded;
- **guarded publishes**: retries with backoff via the shared
  :class:`~torchmetrics_tpu_torch._resilience.policy.RetryPolicy`;
  exhausted retries retain the delta for the next epoch
  (``fleet_publish_degraded``).

The nodes' metrics live on their template's device, and only their
owning thread touches them: the send threads carry bytes
(:mod:`~torchmetrics_tpu_torch._fleet.node`). The KV transport is in-process
(:class:`InProcessKV`) or a ``torch.distributed.Store``
(:class:`CoordinationServiceKV`). :mod:`~torchmetrics_tpu_torch._fleet.chaos`
composes kills, corruption, KV faults, stalls, and zombie replays against a
3-level in-process tree and asserts golden equality over the fenced epochs.
"""

from torchmetrics_tpu_torch._fleet.chaos import (
    FleetChaosResult,
    FleetChaosSpec,
    run_fleet_chaos,
)
from torchmetrics_tpu_torch._fleet.node import AggregationNode, Rollup
from torchmetrics_tpu_torch._fleet.observe import RegionLabeler
from torchmetrics_tpu_torch._fleet.transport import (
    CoordinationServiceKV,
    FleetTransportError,
    InjectedKvFault,
    InProcessKV,
    contribution_key,
    contribution_prefix,
)
from torchmetrics_tpu_torch._fleet.tree import FleetTree
from torchmetrics_tpu_torch._fleet.wire import (
    Contribution,
    CorruptContribution,
    decode_contribution,
    encode_contribution,
)

__all__ = [
    "AggregationNode",
    "Contribution",
    "CoordinationServiceKV",
    "CorruptContribution",
    "FleetChaosResult",
    "FleetChaosSpec",
    "FleetTransportError",
    "FleetTree",
    "InProcessKV",
    "InjectedKvFault",
    "RegionLabeler",
    "Rollup",
    "contribution_key",
    "contribution_prefix",
    "decode_contribution",
    "encode_contribution",
    "run_fleet_chaos",
]
