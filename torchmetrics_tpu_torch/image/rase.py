"""RelativeAverageSpectralError class (port of ``torchmetrics_tpu/image/rase.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.misc import relative_average_spectral_error
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class RelativeAverageSpectralError(Metric):
    """RASE over streaming batches (``cat`` states, computed at the end)."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Append a batch of images."""
        self.preds.append(torch.as_tensor(preds, device=self.device).to(torch.float32))
        self.target.append(torch.as_tensor(target, device=self.device).to(torch.float32))

    def compute(self) -> Tensor:
        """RASE over all accumulated images."""
        return relative_average_spectral_error(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.window_size)
