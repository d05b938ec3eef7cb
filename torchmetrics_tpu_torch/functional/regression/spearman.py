"""Spearman rank correlation (port of ``torchmetrics_tpu/functional/regression/spearman.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs, _rank_data
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _spearman_corrcoef_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if not (torch.is_floating_point(preds) and torch.is_floating_point(target)):
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {preds.dtype} and {target.dtype}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds.to(torch.float32), target.to(torch.float32)


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    if preds.ndim == 1:
        preds = _rank_data(preds)
        target = _rank_data(target)
    else:
        preds = _rank_data(preds.T).T
        target = _rank_data(target.T).T
    preds_diff = preds - preds.mean(dim=0)
    target_diff = target - target.mean(dim=0)
    cov = (preds_diff * target_diff).mean(dim=0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(dim=0))
    target_std = torch.sqrt((target_diff * target_diff).mean(dim=0))
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation.

    Example:
        >>> import torch
        >>> spearman_corrcoef(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(1.0000)
    """
    preds = torch.as_tensor(preds)
    num_outputs = 1 if preds.ndim == 1 else preds.shape[1]
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs)
    return _spearman_corrcoef_compute(preds, target)
