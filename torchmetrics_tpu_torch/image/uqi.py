"""UniversalImageQualityIndex class (port of ``torchmetrics_tpu/image/uqi.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import universal_image_quality_index
from torchmetrics_tpu_torch.metric import Metric


class UniversalImageQualityIndex(Metric):
    """Universal Image Quality Index over streaming batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import UniversalImageQualityIndex
        >>> preds = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(0))
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> round(float(uqi(preds, preds)), 4)
        1.0
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.add_state("sum_uqi", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numel", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image UQI values."""
        vals = universal_image_quality_index(
            torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device),
            self.kernel_size, self.sigma, reduction=None,
        )
        self.sum_uqi += vals.sum()
        self.numel += vals.shape[0]

    def compute(self) -> Tensor:
        """Aggregate UQI over all batches."""
        if self.reduction == "sum":
            return self.sum_uqi.clone()
        return self.sum_uqi / self.numel
