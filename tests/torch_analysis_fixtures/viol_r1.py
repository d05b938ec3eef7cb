"""True-positive fixture for R1: unregistered-state mutation in compiled methods.

Expected violations (asserted by line number in test_torch_analysis_rules.py):
  line 17  R1  plain attribute assignment in update
  line 18  R1  container .append() on an unregistered attribute
  line 22  R1  dynamic setattr in compute
"""

import torch

from torchmetrics_tpu_torch.metric import Metric


class BadUnregisteredState(Metric):
    def update(self, preds) -> None:
        self.total = self.total + preds.sum()
        self.seen_batches = 1
        self.history.append(preds)

    def compute(self):
        name = "tot" + "al"
        setattr(self, name, self.total)
        return self.total

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")
        self.history = []
