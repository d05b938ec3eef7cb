"""Mean absolute error (port of ``torchmetrics_tpu/functional/regression/mae.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_absolute_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    return torch.sum(torch.abs(preds - target), dim=0), target.shape[0]


def _mean_absolute_error_compute(sum_abs_error: Tensor, total: Union[int, Tensor]) -> Tensor:
    return sum_abs_error / total


def mean_absolute_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    """Mean absolute error.

    Example:
        >>> import torch
        >>> mean_absolute_error(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
        tensor(0.2500)
    """
    sum_abs_error, total = _mean_absolute_error_update(preds, target, num_outputs)
    return _mean_absolute_error_compute(sum_abs_error, total)
