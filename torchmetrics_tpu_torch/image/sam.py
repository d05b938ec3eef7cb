"""SpectralAngleMapper class (port of ``torchmetrics_tpu/image/sam.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import spectral_angle_mapper
from torchmetrics_tpu_torch.metric import Metric


class SpectralAngleMapper(Metric):
    """Spectral Angle Mapper (radians) over streaming batches."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction
        self.add_state("sum_sam", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numel", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-pixel spectral angles."""
        vals = spectral_angle_mapper(
            torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device), reduction=None
        )
        self.sum_sam += vals.sum()
        self.numel += vals.numel()

    def compute(self) -> Tensor:
        """Aggregate SAM over all batches."""
        if self.reduction == "sum":
            return self.sum_sam.clone()
        return self.sum_sam / self.numel
