"""VisualInformationFidelity class (port of ``torchmetrics_tpu/image/vif.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.vif import _vif_per_channel
from torchmetrics_tpu_torch.metric import Metric


class VisualInformationFidelity(Metric):
    """Pixel-based VIF over streaming batches."""

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = float(sigma_n_sq)
        self.add_state("vif_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the VIF of every image and channel."""
        preds = torch.as_tensor(preds, device=self.device).to(torch.float32)
        target = torch.as_tensor(target, device=self.device).to(torch.float32)
        per_channel = _vif_per_channel(preds, target, self.sigma_n_sq)
        self.vif_score += per_channel.sum()
        self.total += per_channel.numel()

    def compute(self) -> Tensor:
        """Aggregate VIF over all batches."""
        return self.vif_score / self.total
