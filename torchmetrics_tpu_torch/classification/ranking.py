"""Modular multilabel ranking metrics (port of ``torchmetrics_tpu/classification/ranking.py``).

Each keeps a float32 score sum and a float32 row count, updated in place.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_format,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric


class _RankingMetricBase(Metric):
    is_differentiable = False
    full_state_update = False
    _update_fn = None

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args and (not isinstance(num_labels, int) or num_labels < 2):
            raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_ranking_format(preds, target, self.num_labels, self.ignore_index)
        measure, total = type(self)._update_fn(preds, target)
        self.measure += measure
        self.total += total

    def compute(self) -> Tensor:
        return self.measure / self.total


class MultilabelCoverageError(_RankingMetricBase):
    """Coverage error: average search depth to cover all relevant labels.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelCoverageError
        >>> metric = MultilabelCoverageError(num_labels=3, device="cpu")
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(1.3333)
    """

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_RankingMetricBase):
    """Label-ranking average precision."""

    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_RankingMetricBase):
    """Label-ranking loss: fraction of mis-ordered label pairs."""

    higher_is_better = False
    plot_lower_bound: float = 0.0
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
