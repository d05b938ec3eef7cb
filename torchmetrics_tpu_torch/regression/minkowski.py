"""MinkowskiDistance (port of ``torchmetrics_tpu/regression/minkowski.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.minkowski import (
    _minkowski_distance_compute,
    _minkowski_distance_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


class MinkowskiDistance(Metric):
    """Minkowski distance of order p.

    Example:
        >>> import torch
        >>> metric = MinkowskiDistance(p=3, device="cpu")
        >>> metric.update(torch.tensor([1., 2., 3.]), torch.tensor([1., 2., 4.]))
        >>> metric.compute()
        tensor(1.)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(p, (float, int)) and p >= 1):
            raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
        self.p = p
        self.add_state("minkowski_dist_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        self.minkowski_dist_sum += _minkowski_distance_update(preds, targets, self.p)

    def compute(self) -> Tensor:
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)
