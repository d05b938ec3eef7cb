"""True-positive fixture for R4: value-dependent output shapes."""

import torch

from torchmetrics_tpu_torch.metric import Metric


class BadDynamicShapes(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds, target) -> None:
        labels = torch.unique(target)
        kept = preds[preds > 0]
        (idx,) = torch.where(target > 0)
        self.total = self.total + kept.sum() + labels.sum() + idx.sum()

    def compute(self):
        return self.total
