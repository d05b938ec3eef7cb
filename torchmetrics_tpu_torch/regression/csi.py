"""CriticalSuccessIndex (port of ``torchmetrics_tpu/regression/csi.py``).

The counts are int64 (the JAX package's are int32 and wrap past 2**31 - 1).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.csi import (
    _critical_success_index_compute,
    _critical_success_index_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class CriticalSuccessIndex(Metric):
    """Critical success index (threat score).

    Example:
        >>> import torch
        >>> metric = CriticalSuccessIndex(0.5, device="cpu")
        >>> metric.update(torch.tensor([0.8, 0.2, 0.7]), torch.tensor([0.9, 0.1, 0.2]))
        >>> metric.compute()
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, threshold: float, keep_sequence_dim: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(threshold, (int, float)):
            raise ValueError(f"Expected argument `threshold` to be a float or int, but got {threshold}")
        self.threshold = float(threshold)
        if keep_sequence_dim is not None and not isinstance(keep_sequence_dim, bool):
            raise ValueError(f"Expected argument `keep_sequence_dim` to be bool, but got {keep_sequence_dim}")
        self.keep_sequence_dim = keep_sequence_dim
        for name in ("hits", "misses", "false_alarms"):
            if keep_sequence_dim:
                self.add_state(name, default=[], dist_reduce_fx="cat")
            else:
                self.add_state(name, default=torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        counts = _critical_success_index_update(preds, target, self.threshold, self.keep_sequence_dim)
        for name, count in zip(("hits", "misses", "false_alarms"), counts):
            if self.keep_sequence_dim:
                getattr(self, name).append(count)
            else:
                getattr(self, name).add_(count)

    def compute(self) -> Tensor:
        if self.keep_sequence_dim:
            return _critical_success_index_compute(*(dim_zero_cat(getattr(self, name))
                                                     for name in ("hits", "misses", "false_alarms")))
        return _critical_success_index_compute(self.hits, self.misses, self.false_alarms)
