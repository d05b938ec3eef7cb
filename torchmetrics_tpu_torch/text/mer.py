"""MatchErrorRate (port of ``torchmetrics_tpu/text/mer.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update
from torchmetrics_tpu_torch.metric import Metric


class MatchErrorRate(Metric):
    """Match error rate of automatic-speech-recognition output.

    Example:
        >>> from torchmetrics_tpu_torch.text import MatchErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> mer = MatchErrorRate(device="cpu")
        >>> round(float(mer(preds, target)), 4)
        0.4444
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        errors, total = _mer_update(preds, target, self.device)
        self.errors += errors
        self.total += total

    def compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)
