"""TweedieDevianceScore (port of ``torchmetrics_tpu/regression/tweedie_deviance.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from torchmetrics_tpu_torch.metric import Metric


class TweedieDevianceScore(Metric):
    """Tweedie deviance score.

    Example:
        >>> import torch
        >>> metric = TweedieDevianceScore(power=2, device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.5, 2.5, 4.5]))
        >>> metric.compute()
        tensor(0.1440)
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score += sum_deviance_score
        self.num_observations += num_observations

    def compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
