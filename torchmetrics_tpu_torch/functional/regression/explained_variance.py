"""Explained variance (port of ``torchmetrics_tpu/functional/regression/explained_variance.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    num_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return num_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    num_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / num_obs
    numerator = sum_squared_error / num_obs - diff_avg * diff_avg
    target_avg = sum_target / num_obs
    denominator = sum_squared_target / num_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    one = torch.ones_like(numerator)
    output_scores = torch.where(
        valid_score,
        1.0 - torch.where(valid_score, numerator, one) / torch.where(valid_score, denominator, one),
        torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, 1.0),
    )

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> explained_variance(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.9572)
    """
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, but got {multioutput}")
    num_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(num_obs, sum_error, ss_error, sum_target, ss_target, multioutput)
