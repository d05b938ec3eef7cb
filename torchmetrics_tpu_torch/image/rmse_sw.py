"""RootMeanSquaredErrorUsingSlidingWindow class (port of ``torchmetrics_tpu/image/rmse_sw.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import root_mean_squared_error_using_sliding_window
from torchmetrics_tpu_torch.metric import Metric


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """Sliding-window RMSE over streaming batches."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer")
        self.window_size = window_size
        self.add_state("rmse_val_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image sliding-window RMSE."""
        vals = root_mean_squared_error_using_sliding_window(
            torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device),
            self.window_size, reduction=None,
        )
        self.rmse_val_sum += vals.sum()
        self.total_images += vals.shape[0]

    def compute(self) -> Optional[Tensor]:
        """Aggregate RMSE over all batches."""
        return self.rmse_val_sum / self.total_images
