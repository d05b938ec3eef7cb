"""False-positive twin for R4: static-size variants, 3-arg where, and the
`# lint: eager-helper` whitelist."""

import torch

from torchmetrics_tpu_torch.metric import Metric


class GoodStaticShapes(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds, target) -> None:
        labels = torch.nonzero_static(target, size=4, fill_value=0)  # static size= is safe
        kept = torch.where(preds > 0, preds, 0.0)  # 3-arg where keeps shape
        self.total = self.total + kept.sum() + labels.sum()

    def compute(self):  # lint: eager-helper — value-dependent grouping runs on host by design
        bins = torch.nonzero(self.total[None] > 0)[0]
        return self.total + bins.sum()
