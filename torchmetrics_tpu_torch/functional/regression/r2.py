"""R² score (port of ``torchmetrics_tpu/functional/regression/r2.py``).

The sample count is read back to the host once a ``compute``: it decides
the two-sample check and the adjusted score's branches, and their warnings.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _vmapped
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            f"Expected both prediction and target to be 1D or 2D tensors, but received tensors with dimension {preds.shape}"
        )
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = torch.sum((target - preds) ** 2, dim=0)
    return sum_squared_obs, sum_obs, residual, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    residual: Tensor,
    total: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    # a vmapped lane (a stream pool's compute) has no host value: the checks
    # and warnings are skipped and the adjusted score is chosen on the
    # device, as under the JAX package's trace
    n = None if _vmapped(total) else int(total)
    if n is not None and n < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    mean_obs = sum_obs / total
    tss = sum_squared_obs - sum_obs * mean_obs
    # constant targets: tss ~ 0 and rss ~ 0 is a perfect prediction (1.0), tss ~ 0 and rss > 0 an imperfect one (0.0)
    atol = 1e-8
    cond_rss = residual > atol
    cond_tss = tss > atol
    raw_scores = torch.where(
        cond_rss & cond_tss,
        1 - (residual / torch.where(cond_tss, tss, torch.ones_like(tss))),
        torch.where(cond_rss & ~cond_tss, 0.0, 1.0),
    )

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / tss_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if not isinstance(adjusted, int) or adjusted < 0:
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0 and n is None:
        denom = total - adjusted - 1
        adj = 1 - (1 - r2) * (total - 1) / torch.where(denom > 0, denom, 1)
        return torch.where(denom > 0, adj, r2)
    if adjusted != 0:
        if adjusted > n - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            return 1 - (1 - r2) * (n - 1) / (n - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """R² (coefficient of determination).

    Example:
        >>> import torch
        >>> r2_score(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.9486)
    """
    sum_squared_obs, sum_obs, residual, total = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, residual, total, adjusted, multioutput)
