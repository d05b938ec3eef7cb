"""Minkowski distance (port of ``torchmetrics_tpu/functional/regression/minkowski.py``)."""

from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


def _minkowski_distance_update(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    _check_same_shape(preds, targets)
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
    preds = torch.as_tensor(preds, dtype=torch.float32)
    targets = torch.as_tensor(targets, dtype=torch.float32)
    return torch.sum(torch.abs(preds - targets) ** p)


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    return distance ** (1.0 / p)


def minkowski_distance(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """Minkowski distance of order p.

    Example:
        >>> import torch
        >>> minkowski_distance(torch.tensor([1., 2., 3.]), torch.tensor([1., 2., 4.]), p=2)
        tensor(1.)
    """
    distance = _minkowski_distance_update(preds, targets, p)
    return _minkowski_distance_compute(distance, p)
