"""MAPE, SMAPE and WMAPE (port of ``torchmetrics_tpu/regression/mape.py``).

``total`` is a float32 count, as in the JAX package; it counts exactly up
to 2**24 observations and rounds past that.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
    _symmetric_mean_absolute_percentage_error_update,
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from torchmetrics_tpu_torch.metric import Metric


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([1., 2., 4.]), torch.tensor([1., 2., 2.]))
        >>> metric.compute()
        tensor(0.3333)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error += s
        self.total += n

    def compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class SymmetricMeanAbsolutePercentageError(MeanAbsolutePercentageError):
    """Symmetric MAPE (bounded in [0, 2])."""

    plot_upper_bound: float = 2.0

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error += s
        self.total += n


class WeightedMeanAbsolutePercentageError(Metric):
    """Weighted MAPE: sum|p-t| / sum|t|."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        e, s = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error += e
        self.sum_scale += s

    def compute(self) -> Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)
