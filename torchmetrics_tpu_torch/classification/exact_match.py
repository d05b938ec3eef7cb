"""Modular exact-match metrics (port of ``torchmetrics_tpu/classification/exact_match.py``).

``multidim_average="global"`` keeps int32 ``correct``/``total`` sums, updated
in place; ``"samplewise"`` keeps them as ``cat`` states (ring buffers under
``cat_state_capacity``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_value_flags,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoBinary


class _AbstractExactMatch(Metric):
    """Owns the correct/total states shared by both task flavors."""

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, correct: Tensor, total: Tensor) -> None:
        if isinstance(self.correct, Tensor):
            self.correct += correct
            self.total += total
        else:
            self.correct.append(correct)
            self.total.append(total)

    def _final_state(self) -> Tuple[Tensor, Tensor]:
        return dim_zero_cat(self.correct), dim_zero_cat(self.total)

    def compute(self) -> Tensor:
        correct, total = self._final_state()
        return _exact_match_reduce(correct, total)


class MulticlassExactMatch(_AbstractExactMatch):
    """Multiclass exact match.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassExactMatch
        >>> target = torch.tensor([[0, 2, 1], [2, 1, 0]])
        >>> preds = torch.tensor([[0, 2, 1], [2, 1, 1]])
        >>> metric = MulticlassExactMatch(num_classes=3, device="cpu")
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        correct, total = _multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index)
        self._update_state(correct, total)

    def _traced_value_flags(self, preds: Tensor, target: Tensor) -> Tuple[Tuple[str, ...], Tensor]:
        return _multiclass_stat_scores_value_flags(preds, target, self.num_classes, self.ignore_index)


class MultilabelExactMatch(_AbstractExactMatch):
    """Multilabel exact match."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target, valid = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        correct, total = _multilabel_exact_match_update(preds, target, valid, self.multidim_average)
        self._update_state(correct, total)


class ExactMatch(_ClassificationTaskWrapper):
    """Task-dispatching ExactMatch (no binary flavor, as in the reference)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update({
            "multidim_average": multidim_average,
            "ignore_index": ignore_index,
            "validate_args": validate_args,
        })
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassExactMatch(num_classes, **kwargs)
        if task == ClassificationTaskNoBinary.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelExactMatch(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
