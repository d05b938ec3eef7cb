"""Mean squared error (port of ``torchmetrics_tpu/functional/regression/mse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds - target
    return torch.sum(diff * diff, dim=0), target.shape[0]


def _mean_squared_error_compute(sum_squared_error: Tensor, total: Union[int, Tensor], squared: bool = True) -> Tensor:
    mse = sum_squared_error / total
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """Mean squared error (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> mean_squared_error(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
        tensor(0.2500)
    """
    sum_squared_error, total = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, total, squared)
