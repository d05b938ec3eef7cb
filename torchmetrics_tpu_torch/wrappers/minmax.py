"""MinMaxMetric (port of ``torchmetrics_tpu/wrappers/minmax.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class MinMaxMetric(WrapperMetric):
    """Track the running min and max of another metric's ``compute`` value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import MinMaxMetric
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
        >>> _ = metric(torch.tensor([1.0, 0.0]), torch.tensor([1, 1]))
        >>> sorted(metric.compute().keys())
        ['max', 'min', 'raw']
    """

    full_state_update: bool = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected base metric to be an instance of `Metric` but received {base_metric}")
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        # plain attributes, not managed states (reference minmax.py:78-79): every compute(), the batch
        # computes inside forward's double-update path included, folds into the running min and max
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(-float("inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar, but got {val}")
        val = torch.as_tensor(val, dtype=torch.float32, device=self.device)
        self.max_val = torch.where(self.max_val < val, val, self.max_val)
        self.min_val = torch.where(self.min_val > val, val, self.min_val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        # min and max survive reset: forward's double-update path resets between the global and the
        # batch compute, and the reference's reset (minmax.py:103-106) leaves them untouched
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
