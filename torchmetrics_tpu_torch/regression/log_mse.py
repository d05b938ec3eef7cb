"""MeanSquaredLogError and LogCoshError (port of ``torchmetrics_tpu/regression/log_mse.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.log_mse import (
    _log_cosh_error_compute,
    _log_cosh_error_update,
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from torchmetrics_tpu_torch.metric import Metric


class MeanSquaredLogError(Metric):
    """Mean squared logarithmic error.

    Example:
        >>> import torch
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> metric.update(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
        >>> metric.compute()
        tensor(0.0207)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error += s
        self.total += n

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)


class LogCoshError(Metric):
    """LogCosh error.

    Example:
        >>> import torch
        >>> metric = LogCoshError(device="cpu")
        >>> metric.update(torch.tensor([3.0, 5.0, 2.5]), torch.tensor([0.25, 5.0, 4.0]))
        >>> metric.compute()
        tensor(0.9721)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        s, n = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error += s
        self.total += n

    def compute(self) -> Tensor:
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)
