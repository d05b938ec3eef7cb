"""False-positive twin for R2: scalar conversions of host-only values
(config ints, shapes, numpy-annotated params) never fire."""

import torch
import numpy as np

from torchmetrics_tpu_torch.metric import Metric


class GoodHostMath(Metric):
    def __init__(self, num_outputs: int = 1, **kwargs):
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds) -> None:
        scale = float(self.num_outputs)  # config attr, not a tensor value
        n = int(preds.shape[0])  # shapes are static metadata under trace
        self.total = self.total + preds.sum() * scale / max(n, 1)

    def compute(self):
        return self.total


def _good_kernel_update(lengths: "np.ndarray", n_gram: int):
    numerator = np.zeros(n_gram)  # host constants from host-only params
    return numerator + float(lengths.sum())
