"""Modular recall at fixed precision and precision at fixed recall
(port of ``torchmetrics_tpu/classification/recall_fixed_precision.py``).

The metrics keep the precision-recall curve's states.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
)
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _per_class_fixed_op,
    _precision_at_recall,
    _recall_at_precision,
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """Max recall with precision >= ``min_precision``; returns (recall, threshold).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecallAtFixedPrecision
        >>> metric = BinaryRecallAtFixedPrecision(min_precision=1.0, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 1, 1, 1]))
        >>> recall, threshold = metric.compute()
        >>> float(recall)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        min_precision: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args and (not isinstance(min_precision, float) or not (0 <= min_precision <= 1)):
            raise ValueError(
                f"Expected argument `min_precision` to be an float in the [0,1] range, but got {min_precision}"
            )
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, thresholds = _binary_precision_recall_curve_compute(self._final_state(), self.thresholds)
        return _recall_at_precision(precision, recall, thresholds, self.min_precision)


class BinaryPrecisionAtFixedRecall(BinaryPrecisionRecallCurve):
    """Max precision with recall >= ``min_recall``; returns (precision, threshold)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        min_recall: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args and (not isinstance(min_recall, float) or not (0 <= min_recall <= 1)):
            raise ValueError(f"Expected argument `min_recall` to be an float in the [0,1] range, but got {min_recall}")
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, thresholds = _binary_precision_recall_curve_compute(self._final_state(), self.thresholds)
        return _precision_at_recall(precision, recall, thresholds, self.min_recall)


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """Per-class max recall with precision >= ``min_precision``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_legend_name = "Class"

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, thresholds = _multiclass_precision_recall_curve_compute(
            self._final_state(), self.num_classes, self.thresholds
        )
        return _per_class_fixed_op(precision, recall, thresholds, self.num_classes, self.min_precision, _recall_at_precision)


class MulticlassPrecisionAtFixedRecall(MulticlassPrecisionRecallCurve):
    """Per-class max precision with recall >= ``min_recall``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_legend_name = "Class"

    def __init__(
        self,
        num_classes: int,
        min_recall: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, thresholds = _multiclass_precision_recall_curve_compute(
            self._final_state(), self.num_classes, self.thresholds
        )
        return _per_class_fixed_op(precision, recall, thresholds, self.num_classes, self.min_recall, _precision_at_recall)


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """Per-label max recall with precision >= ``min_precision``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_legend_name = "Label"

    def __init__(
        self,
        num_labels: int,
        min_precision: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, thresholds = _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )
        return _per_class_fixed_op(precision, recall, thresholds, self.num_labels, self.min_precision, _recall_at_precision)


class MultilabelPrecisionAtFixedRecall(MultilabelPrecisionRecallCurve):
    """Per-label max precision with recall >= ``min_recall``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_legend_name = "Label"

    def __init__(
        self,
        num_labels: int,
        min_recall: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_recall = min_recall

    def compute(self) -> Tuple[Tensor, Tensor]:
        precision, recall, thresholds = _multilabel_precision_recall_curve_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )
        return _per_class_fixed_op(precision, recall, thresholds, self.num_labels, self.min_recall, _precision_at_recall)


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task-dispatching recall at fixed precision."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_precision: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinaryRecallAtFixedPrecision(min_precision, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassRecallAtFixedPrecision(
                num_classes, min_precision, thresholds, ignore_index, validate_args, **kwargs
            )
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelRecallAtFixedPrecision(
                num_labels, min_precision, thresholds, ignore_index, validate_args, **kwargs
            )
        raise ValueError(f"Task {task} not supported!")


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Task-dispatching precision at fixed recall."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_recall: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionAtFixedRecall(min_recall, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassPrecisionAtFixedRecall(
                num_classes, min_recall, thresholds, ignore_index, validate_args, **kwargs
            )
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelPrecisionAtFixedRecall(
                num_labels, min_recall, thresholds, ignore_index, validate_args, **kwargs
            )
        raise ValueError(f"Task {task} not supported!")
