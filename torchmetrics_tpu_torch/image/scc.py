"""SpatialCorrelationCoefficient class (port of ``torchmetrics_tpu/image/scc.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import spatial_correlation_coefficient
from torchmetrics_tpu_torch.metric import Metric


class SpatialCorrelationCoefficient(Metric):
    """Spatial Correlation Coefficient over streaming batches."""

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(self, high_pass_filter: Optional[Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.high_pass_filter = high_pass_filter
        self.window_size = window_size
        self.add_state("scc_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image SCC values."""
        vals = spatial_correlation_coefficient(
            torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device),
            hp_filter=self.high_pass_filter, window_size=self.window_size, reduction=None,
        )
        self.scc_score += vals.sum()
        self.total += vals.shape[0]

    def compute(self) -> Tensor:
        """Aggregate SCC over all batches."""
        return self.scc_score / self.total
