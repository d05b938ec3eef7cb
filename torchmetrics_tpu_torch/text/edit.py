"""EditDistance (port of ``torchmetrics_tpu/text/edit.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.edit import _edit_distance_compute, _edit_distance_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class EditDistance(Metric):
    """Character-level Levenshtein edit distance with a configurable reduction.

    ``"mean"``/``"sum"`` keep (sum of distances, count) as ``sum`` states;
    ``"none"``/``None`` keep the per-sample distances as a ``cat`` list state.

    Example:
        >>> from torchmetrics_tpu_torch.text import EditDistance
        >>> metric = EditDistance(device="cpu")
        >>> float(metric(["rain"], ["shine"]))
        3.0
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        allowed_reduction = (None, "mean", "sum", "none")
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction}, but got {reduction}")
        self.substitution_cost = substitution_cost
        self.reduction = reduction

        if self.reduction == "none" or self.reduction is None:
            self.add_state("edit_scores_list", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("edit_scores", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("num_elements", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        distances = _edit_distance_update(preds, target, self.substitution_cost, self.device)
        if self.reduction == "none" or self.reduction is None:
            self.edit_scores_list.append(distances)
        else:
            self.edit_scores += distances.sum()
            self.num_elements += distances.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "none" or self.reduction is None:
            return _edit_distance_compute(dim_zero_cat(self.edit_scores_list), 1, self.reduction)
        return _edit_distance_compute(self.edit_scores.reshape(1), self.num_elements, self.reduction)
