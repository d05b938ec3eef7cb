"""Mean squared log error and log-cosh error (port of ``torchmetrics_tpu/functional/regression/log_mse.py``)."""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    d = torch.log1p(preds) - torch.log1p(target)
    return torch.sum(d * d), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, num_obs: Union[int, Tensor]) -> Tensor:
    return sum_squared_log_error / num_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean squared logarithmic error.

    Example:
        >>> import torch
        >>> mean_squared_log_error(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
        tensor(0.0207)
    """
    s, n = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(s, n)


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds - target
    # log(cosh(x)) = x + softplus(-2x) - log(2), finite for any float32 x
    return torch.sum(diff + F.softplus(-2.0 * diff) - math.log(2.0), dim=0), target.shape[0]


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, total: Union[int, Tensor]) -> Tensor:
    return (sum_log_cosh_error / total).squeeze()


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """LogCosh error.

    Example:
        >>> import torch
        >>> log_cosh_error(torch.tensor([3.0, 5.0, 2.5]), torch.tensor([0.25, 5.0, 4.0]))
        tensor(0.9721)
    """
    preds = torch.as_tensor(preds)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[1]
    s, n = _log_cosh_error_update(preds, target, num_outputs)
    return _log_cosh_error_compute(s, n)
