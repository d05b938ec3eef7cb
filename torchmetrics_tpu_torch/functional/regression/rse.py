"""Relative squared error (port of ``torchmetrics_tpu/functional/regression/rse.py``)."""

from __future__ import annotations

from typing import Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.r2 import _r2_score_update


def _relative_squared_error_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    sum_squared_error: Tensor,
    total: Union[int, Tensor],
    squared: bool = True,
) -> Tensor:
    epsilon = torch.finfo(torch.float32).eps
    rse = sum_squared_error / torch.clamp(sum_squared_obs - sum_obs * sum_obs / total, min=epsilon)
    if not squared:
        rse = torch.sqrt(rse)
    return torch.mean(rse)


def relative_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """Relative squared error (or root-RSE with ``squared=False``).

    Example:
        >>> import torch
        >>> relative_squared_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.0514)
    """
    sum_squared_obs, sum_obs, rss, total = _r2_score_update(preds, target)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, total, squared=squared)
