"""Modular specificity at sensitivity and sensitivity at specificity
(port of ``torchmetrics_tpu/classification/specificity_sensitivity.py``).

The metrics keep the precision-recall curve's states and read the ROC curve from them.
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
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.functional.classification.specificity_sensitivity import (
    _per_class_roc_fixed_op,
    _sensitivity_at_specificity,
    _specificity_at_sensitivity,
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """Max specificity with sensitivity >= ``min_sensitivity``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificityAtSensitivity
        >>> metric = BinarySpecificityAtSensitivity(min_sensitivity=1.0, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> spec, thr = metric.compute()
        >>> float(spec)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        min_sensitivity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        fpr, tpr, thresholds = _binary_roc_compute(self._final_state(), self.thresholds)
        return _specificity_at_sensitivity(fpr, tpr, thresholds, self.min_sensitivity)


class BinarySensitivityAtSpecificity(BinaryPrecisionRecallCurve):
    """Max sensitivity with specificity >= ``min_specificity``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        min_specificity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        fpr, tpr, thresholds = _binary_roc_compute(self._final_state(), self.thresholds)
        return _sensitivity_at_specificity(fpr, tpr, thresholds, self.min_specificity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Per-class max specificity with sensitivity >= constraint."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        min_sensitivity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        fpr, tpr, thresholds = _multiclass_roc_compute(self._final_state(), self.num_classes, self.thresholds)
        return _per_class_roc_fixed_op(
            fpr, tpr, thresholds, self.num_classes, self.min_sensitivity, _specificity_at_sensitivity
        )


class MulticlassSensitivityAtSpecificity(MulticlassPrecisionRecallCurve):
    """Per-class max sensitivity with specificity >= constraint."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        min_specificity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        fpr, tpr, thresholds = _multiclass_roc_compute(self._final_state(), self.num_classes, self.thresholds)
        return _per_class_roc_fixed_op(
            fpr, tpr, thresholds, self.num_classes, self.min_specificity, _sensitivity_at_specificity
        )


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Per-label max specificity with sensitivity >= constraint."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        min_sensitivity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[Tensor, Tensor]:
        fpr, tpr, thresholds = _multilabel_roc_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )
        return _per_class_roc_fixed_op(
            fpr, tpr, thresholds, self.num_labels, self.min_sensitivity, _specificity_at_sensitivity
        )


class MultilabelSensitivityAtSpecificity(MultilabelPrecisionRecallCurve):
    """Per-label max sensitivity with specificity >= constraint."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        min_specificity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs
        )
        self.min_specificity = min_specificity

    def compute(self) -> Tuple[Tensor, Tensor]:
        fpr, tpr, thresholds = _multilabel_roc_compute(
            self._final_state(), self.num_labels, self.thresholds, self.ignore_index
        )
        return _per_class_roc_fixed_op(
            fpr, tpr, thresholds, self.num_labels, self.min_specificity, _sensitivity_at_specificity
        )


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task-dispatching specificity at sensitivity."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinarySpecificityAtSensitivity(min_sensitivity, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassSpecificityAtSensitivity(
                num_classes, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            )
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelSpecificityAtSensitivity(
                num_labels, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            )
        raise ValueError(f"Task {task} not supported!")


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Task-dispatching sensitivity at specificity."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_specificity: float,
        thresholds: Optional[Union[int, List[float], Tensor]] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        if task == ClassificationTask.BINARY:
            return BinarySensitivityAtSpecificity(min_specificity, thresholds, ignore_index, validate_args, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassSensitivityAtSpecificity(
                num_classes, min_specificity, thresholds, ignore_index, validate_args, **kwargs
            )
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelSensitivityAtSpecificity(
                num_labels, min_specificity, thresholds, ignore_index, validate_args, **kwargs
            )
        raise ValueError(f"Task {task} not supported!")
