"""Task dispatchers for the operating-point metrics (port of
``torchmetrics_tpu/functional/classification/_dispatch_operating_point.py``; reference
``functional/classification/recall_fixed_precision.py:401``,
``precision_fixed_recall.py``, ``specificity_sensitivity.py``): thin routers
to the Binary/Multiclass/Multilabel kernels on ``task``."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    binary_precision_at_fixed_recall,
    binary_recall_at_fixed_precision,
    multiclass_precision_at_fixed_recall,
    multiclass_recall_at_fixed_precision,
    multilabel_precision_at_fixed_recall,
    multilabel_recall_at_fixed_precision,
)
from torchmetrics_tpu_torch.functional.classification.specificity_sensitivity import (
    binary_sensitivity_at_specificity,
    binary_specificity_at_sensitivity,
    multiclass_sensitivity_at_specificity,
    multiclass_specificity_at_sensitivity,
    multilabel_sensitivity_at_specificity,
    multilabel_specificity_at_sensitivity,
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

_Thresholds = Optional[Union[int, List[float], Tensor]]


def _dispatch(task, constraint, binary_fn, multiclass_fn, multilabel_fn, preds, target,
              thresholds, num_classes, num_labels, ignore_index, validate_args):
    task = ClassificationTask.from_str(task) if isinstance(task, str) else task
    if task == ClassificationTask.BINARY:
        return binary_fn(preds, target, constraint, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_fn(preds, target, num_classes, constraint, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_fn(preds, target, num_labels, constraint, thresholds, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")


def recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_precision: float,
    thresholds: _Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Optional[Tuple[Tensor, Tensor]]:
    """Highest recall attainable at a given minimum precision, per task.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import recall_at_fixed_precision
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.9])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> [round(float(x), 2) for x in recall_at_fixed_precision(preds, target, task="binary", min_precision=0.5)]
        [1.0, 0.4]
    """
    return _dispatch(
        task, min_precision,
        binary_recall_at_fixed_precision, multiclass_recall_at_fixed_precision, multilabel_recall_at_fixed_precision,
        preds, target, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_recall: float,
    thresholds: _Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Optional[Tuple[Tensor, Tensor]]:
    """Highest precision attainable at a given minimum recall, per task.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import precision_at_fixed_recall
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.9])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> [round(float(x), 2) for x in precision_at_fixed_recall(preds, target, task="binary", min_recall=0.5)]
        [1.0, 0.4]
    """
    return _dispatch(
        task, min_recall,
        binary_precision_at_fixed_recall, multiclass_precision_at_fixed_recall, multilabel_precision_at_fixed_recall,
        preds, target, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_sensitivity: float,
    thresholds: _Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Optional[Tuple[Tensor, Tensor]]:
    """Highest specificity attainable at a given minimum sensitivity, per task.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import specificity_at_sensitivity
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.9])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> [round(float(x), 2) for x in specificity_at_sensitivity(
        ...     preds, target, task="binary", min_sensitivity=0.5)]
        [1.0, 0.6]
    """
    return _dispatch(
        task, min_sensitivity,
        binary_specificity_at_sensitivity, multiclass_specificity_at_sensitivity, multilabel_specificity_at_sensitivity,
        preds, target, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )


def sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_specificity: float,
    thresholds: _Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Optional[Tuple[Tensor, Tensor]]:
    """Highest sensitivity attainable at a given minimum specificity, per task.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import sensitivity_at_specificity
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.9])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> [round(float(x), 2) for x in sensitivity_at_specificity(
        ...     preds, target, task="binary", min_specificity=0.5)]
        [1.0, 0.4]
    """
    return _dispatch(
        task, min_specificity,
        binary_sensitivity_at_specificity, multiclass_sensitivity_at_specificity, multilabel_sensitivity_at_specificity,
        preds, target, thresholds, num_classes, num_labels, ignore_index, validate_args,
    )
