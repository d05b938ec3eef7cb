"""Concordance correlation coefficient (port of ``torchmetrics_tpu/functional/regression/concordance.py``)."""

from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_update


def _concordance_corrcoef_compute(
    mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor
) -> Tensor:
    """Lin's CCC from the Pearson co-moment state."""
    vx = var_x / nb
    vy = var_y / nb
    cxy = corr_xy / nb
    eps = torch.finfo(torch.float32).eps
    return (2.0 * cxy / torch.clamp(vx + vy + (mean_x - mean_y) ** 2, min=eps)).squeeze()


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Lin's concordance correlation coefficient.

    Example:
        >>> import torch
        >>> concordance_corrcoef(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([3.0, 5.5, 3.0, 7.0]))
        tensor(0.9797)
    """
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    d = preds.shape[1] if preds.ndim == 2 else 1
    zeros = torch.zeros(d, dtype=torch.float32, device=preds.device)
    moments = _pearson_corrcoef_update(preds, target, zeros, zeros, zeros, zeros, zeros, zeros, num_outputs=d)
    return _concordance_corrcoef_compute(*moments)
