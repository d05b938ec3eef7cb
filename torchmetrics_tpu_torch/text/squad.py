"""SQuAD (port of ``torchmetrics_tpu/text/squad.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _flatten_inputs,
    _squad_compute,
    _squad_update,
)
from torchmetrics_tpu_torch.metric import Metric


class SQuAD(Metric):
    """SQuAD exact-match and F1 scores.

    Example:
        >>> from torchmetrics_tpu_torch.text import SQuAD
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> squad = SQuAD(device="cpu")
        >>> {k: float(v) for k, v in squad(preds, target).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        f1, exact_match, total = _squad_update(*_flatten_inputs(preds, target), self.device)
        self.f1_score += f1
        self.exact_match += exact_match
        self.total += total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
