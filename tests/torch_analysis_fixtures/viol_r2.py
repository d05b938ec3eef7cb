"""True-positive fixture for R2: host-sync leaks in compiled paths.

Seeded: `float()` on a tensor reduction, `.item()` on a state, `np.*` on a
batch argument — in a Metric update/compute and in a functional kernel.
"""

import torch
import numpy as np

from torchmetrics_tpu_torch.metric import Metric


class BadHostSync(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds) -> None:
        batch_sum = float(preds.sum())
        self.total = self.total + np.asarray(preds).mean()
        del batch_sum

    def compute(self):
        return self.total.item()


def _bad_kernel_update(preds, target):
    scale = float(torch.abs(target).max())
    return preds / scale
