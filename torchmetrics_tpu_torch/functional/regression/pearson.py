"""Pearson correlation (port of ``torchmetrics_tpu/functional/regression/pearson.py``).

Its distributed merge is algorithmic: each process's (mean, var, cov, n)
moment set is merged with the parallel-variance update in
``_final_aggregation``, not summed. The observation count ``nb`` is float32
as in the JAX package; it counts exactly up to 2**24 observations.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    num_prior: Tensor,
    num_outputs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Streaming update of the co-moments (Welford-style), with no read back to the host."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    num_obs = preds.shape[0]
    cond = (num_prior == 0).all()

    mx_new = torch.where(
        cond, torch.mean(preds, dim=0), (num_prior * mean_x + torch.sum(preds, dim=0)) / (num_prior + num_obs)
    )
    my_new = torch.where(
        cond, torch.mean(target, dim=0), (num_prior * mean_y + torch.sum(target, dim=0)) / (num_prior + num_obs)
    )
    num_prior = num_prior + num_obs
    var_x = var_x + torch.sum((preds - mx_new) * (preds - mean_x), dim=0)
    var_y = var_y + torch.sum((target - my_new) * (target - mean_y), dim=0)
    corr_xy = corr_xy + torch.sum((preds - mx_new) * (target - mean_y), dim=0)
    return mx_new, my_new, var_x, var_y, corr_xy, num_prior


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """The correlation from the accumulated co-moments."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    eps = torch.finfo(torch.float32).eps
    corrcoef = corr_xy / torch.clamp(torch.sqrt(var_x * var_y), min=eps)
    return torch.clamp(corrcoef, -1.0, 1.0).squeeze()


def _final_aggregation(
    means_x: Tensor,
    means_y: Tensor,
    vars_x: Tensor,
    vars_y: Tensor,
    corrs_xy: Tensor,
    nbs: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Merge ``(D, ...)`` moment sets into one, left to right (parallel-variance fold)."""
    acc = (means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0])
    for i in range(1, means_x.shape[0]):
        mx1, my1, vx1, vy1, cxy1, n1 = acc
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        safe_nb = torch.where(nb == 0, torch.ones_like(nb), nb)
        mean_x = (n1 * mx1 + n2 * mx2) / safe_nb
        mean_y = (n1 * my1 + n2 * my2) / safe_nb
        vx = vx1 + vx2 + n1 * n2 / safe_nb * (mx1 - mx2) ** 2
        vy = vy1 + vy2 + n1 * n2 / safe_nb * (my1 - my2) ** 2
        cxy = cxy1 + cxy2 + n1 * n2 / safe_nb * (mx1 - mx2) * (my1 - my2)
        acc = (mean_x, mean_y, vx, vy, cxy, nb)
    return acc


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> pearson_corrcoef(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(0.9849)
    """
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    d = preds.shape[1] if preds.ndim == 2 else 1
    zeros = torch.zeros(d, dtype=torch.float32, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, zeros, zeros, zeros, zeros, zeros, zeros, num_outputs=d
    )
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
