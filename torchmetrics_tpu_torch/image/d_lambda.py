"""SpectralDistortionIndex class (port of ``torchmetrics_tpu/image/d_lambda.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import spectral_distortion_index
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class SpectralDistortionIndex(Metric):
    """D_lambda spectral distortion index over streaming batches."""

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(p, int) and p > 0):
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.p = p
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch of images."""
        preds = torch.as_tensor(preds, device=self.device).to(torch.float32)
        target = torch.as_tensor(target, device=self.device).to(torch.float32)
        if preds.shape != target.shape:
            raise ValueError(
                f"Expected `preds` and `target` to have the same shape, got {preds.shape} and {target.shape}"
            )
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """D_lambda over all accumulated images."""
        return spectral_distortion_index(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.p, self.reduction)
