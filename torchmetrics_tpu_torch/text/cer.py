"""CharErrorRate (port of ``torchmetrics_tpu/text/cer.py``)."""

from __future__ import annotations

from typing import Any, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.cer import _cer_compute, _cer_update
from torchmetrics_tpu_torch.metric import Metric


class CharErrorRate(Metric):
    """Character error rate of automatic-speech-recognition output.

    Example:
        >>> from torchmetrics_tpu_torch.text import CharErrorRate
        >>> cer = CharErrorRate(device="cpu")
        >>> round(float(cer(["this is the prediction"], ["this is the reference"])), 4)
        0.381
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        errors, total = _cer_update(preds, target, self.device)
        self.errors += errors
        self.total += total

    def compute(self) -> Tensor:
        return _cer_compute(self.errors, self.total)
