"""ErrorRelativeGlobalDimensionlessSynthesis class (port of ``torchmetrics_tpu/image/ergas.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import error_relative_global_dimensionless_synthesis
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS over streaming batches (``cat`` states, computed at the end)."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch of images."""
        self.preds.append(torch.as_tensor(preds, device=self.device).to(torch.float32))
        self.target.append(torch.as_tensor(target, device=self.device).to(torch.float32))

    def compute(self) -> Tensor:
        """ERGAS over all accumulated images."""
        return error_relative_global_dimensionless_synthesis(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.ratio, self.reduction
        )
