"""TotalVariation class (port of ``torchmetrics_tpu/image/tv.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import total_variation
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class TotalVariation(Metric):
    """Total Variation over streaming batches."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        self.add_state("score_list", default=[], dist_reduce_fx="cat")
        self.add_state("score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_elements", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        """Accumulate per-image total variation."""
        vals = total_variation(torch.as_tensor(img, device=self.device), reduction=None)
        if self.reduction in (None, "none"):
            self.score_list.append(vals)
        else:
            self.score += vals.sum()
            self.num_elements += vals.shape[0]

    def compute(self) -> Tensor:
        """Aggregate total variation."""
        if self.reduction in (None, "none"):
            return dim_zero_cat(self.score_list)
        if self.reduction == "mean":
            return self.score / self.num_elements
        return self.score.clone()
