"""MAPE, SMAPE and WMAPE (port of ``torchmetrics_tpu/functional/regression/mape.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

_EPS = 1.17e-6


def _mean_absolute_percentage_error_update(preds: Tensor, target: Tensor, epsilon: float = _EPS) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> mean_absolute_percentage_error(torch.tensor([1., 2., 4.]), torch.tensor([1., 2., 2.]))
        tensor(0.3333)
    """
    s, n = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(s, n)


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = _EPS
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    abs_per_error = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Symmetric MAPE (bounded to [0, 2])."""
    s, n = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return s / n


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = _EPS
) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Weighted MAPE: sum|p-t| / sum|t|."""
    e, s = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(e, s)
