"""False-positive twin for R3: branching on metadata, identity, dict keys,
and config — never on tensor values."""

from typing import Dict, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric


class GoodControlFlow(Metric):
    def __init__(self, ignore_index: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.ignore_index = ignore_index
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds, extra: Dict[str, torch.Tensor] = None) -> None:
        if self.ignore_index is not None:  # config identity test
            preds = torch.where(preds == self.ignore_index, 0.0, preds)
        if preds.ndim != 1:  # shape metadata
            raise ValueError("expected 1d input")
        if extra is not None and "weights" not in extra:  # dict-key membership
            raise ValueError("missing weights")
        self.total = self.total + torch.where(preds.sum() > 0, preds.sum(), 0.0)

    def compute(self):
        return self.total
