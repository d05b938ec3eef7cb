"""Metrics-as-a-service ingestion runtime.

Port of ``torchmetrics_tpu/_serving/`` (the same six modules and 14 names).
The long-running serving layer over the multi-tenant
:class:`~torchmetrics_tpu_torch._streams.StreamPool`: a bounded ingress
queue with backpressure, a single ingest worker that micro-batches
concurrent update requests into one vmapped pool step (on the card, one
CUDA graph replay a micro-batch), compute/scrape serving while ingesting,
an SLO-closed control loop over micro-batch sizing and load shedding, warm
boot, and the chaos-under-load harness that proves the whole thing
recovers.
"""

from torchmetrics_tpu_torch._serving.controller import (
    BatchController,
    ControllerConfig,
    Decision,
    OK_BURN,
)
from torchmetrics_tpu_torch._serving.chaos import (
    ServingChaosResult,
    ServingChaosSpec,
    run_serving_chaos,
    run_serving_chaos_soak,
)
from torchmetrics_tpu_torch._serving.queue import IngressQueue
from torchmetrics_tpu_torch._serving.requests import (
    Ack,
    BackpressureError,
    ServerClosedError,
    UpdateRequest,
)
from torchmetrics_tpu_torch._serving.runtime import MetricServer

__all__ = [
    "Ack",
    "BackpressureError",
    "BatchController",
    "ControllerConfig",
    "Decision",
    "IngressQueue",
    "MetricServer",
    "OK_BURN",
    "ServerClosedError",
    "ServingChaosResult",
    "ServingChaosSpec",
    "UpdateRequest",
    "run_serving_chaos",
    "run_serving_chaos_soak",
]
