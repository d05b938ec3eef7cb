"""False-positive twin for R1: every mutated attribute is registered state
(or underscore-prefixed metric machinery). Must produce zero violations and
the class must be certified R1-clean."""

import torch

from torchmetrics_tpu_torch.metric import Metric


class GoodRegisteredState(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("chunks", default=[], dist_reduce_fx="cat")  # lint-ok: R10 capacity set per-deployment
        self.window = 8  # config set once at construction is fine

    def update(self, preds) -> None:
        self.total = self.total + preds.sum()
        self.chunks.append(preds)
        self._scratch = preds.shape  # underscore attrs are machinery, exempt

    def compute(self):
        return self.total
