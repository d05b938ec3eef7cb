"""WordInfoPreserved (port of ``torchmetrics_tpu/text/wip.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.wip import _word_info_preserved_compute, _word_info_preserved_update
from torchmetrics_tpu_torch.metric import Metric


class WordInfoPreserved(Metric):
    """Word information preserved of automatic-speech-recognition output.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoPreserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wip = WordInfoPreserved(device="cpu")
        >>> round(float(wip(preds, target)), 4)
        0.3472
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        errors, target_total, preds_total = _word_info_preserved_update(preds, target, self.device)
        self.errors += errors
        self.target_total += target_total
        self.preds_total += preds_total

    def compute(self) -> Tensor:
        return _word_info_preserved_compute(self.errors, self.target_total, self.preds_total)
