"""Critical success index (port of ``torchmetrics_tpu/functional/regression/csi.py``).

Hits, misses and false alarms are int64 counts (the JAX package's are int32).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_divide


def _count(x: Tensor, keep_sequence_dim: bool) -> Tensor:
    if not keep_sequence_dim:
        return torch.sum(x, dtype=torch.int64)
    if x.ndim == 1:  # no axis to reduce past the sequence axis
        return x.to(torch.int64)
    return torch.sum(x, dim=tuple(range(1, x.ndim)), dtype=torch.int64)


def _critical_success_index_update(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds_bin = torch.as_tensor(preds) >= threshold
    target_bin = torch.as_tensor(target) >= threshold
    hits = _count(preds_bin & target_bin, keep_sequence_dim)
    misses = _count(~preds_bin & target_bin, keep_sequence_dim)
    false_alarms = _count(preds_bin & ~target_bin, keep_sequence_dim)
    return hits, misses, false_alarms


def _critical_success_index_compute(hits: Tensor, misses: Tensor, false_alarms: Tensor) -> Tensor:
    return _safe_divide(hits, hits + misses + false_alarms)


def critical_success_index(preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: bool = False) -> Tensor:
    """Critical success index (threat score).

    Example:
        >>> import torch
        >>> critical_success_index(torch.tensor([0.8, 0.2, 0.7]), torch.tensor([0.9, 0.1, 0.2]), threshold=0.5)
        tensor(0.5000)
    """
    hits, misses, false_alarms = _critical_success_index_update(preds, target, threshold, keep_sequence_dim)
    return _critical_success_index_compute(hits, misses, false_alarms)
