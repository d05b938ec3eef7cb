"""Shared mean-aggregating base of the audio metrics (port of ``torchmetrics_tpu/audio/_base.py``).

Every audio class keeps a value sum and a sample count. ``measure_sum`` is
float32, as in the JAX package; ``total`` is int64 (the JAX package's is
int32), as the port's other counts.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric


class _AveragingAudioMetric(Metric):
    """Accumulates a per-sample metric as (sum, count) and computes the mean."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("measure_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int64), dist_reduce_fx="sum")

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _accumulate(self, values: Tensor) -> None:
        self.measure_sum += torch.sum(values.to(self.measure_sum.device)).to(self.measure_sum.dtype)
        self.total += values.numel()

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._accumulate(self._measure(preds, target))

    def compute(self) -> Tensor:
        return self.measure_sum / self.total
