"""True-positive fixture for R3: python control flow on tensor values."""

import torch

from torchmetrics_tpu_torch.metric import Metric


class BadControlFlow(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds) -> None:
        if preds.sum() > 0:
            self.total = self.total + preds.sum()
        assert (preds >= 0).all()

    def compute(self):
        return self.total if self.total > 0 else torch.tensor(0.0)
