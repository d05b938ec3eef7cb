"""Specificity at sensitivity and sensitivity at specificity (port of
``torchmetrics_tpu/functional/classification/specificity_sensitivity.py``; reference
``functional/classification/{specificity_sensitivity,sensitivity_specificity}.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)


def _specificity_at_sensitivity(
    fpr: Tensor, tpr: Tensor, thresholds: Tensor, min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """Max specificity subject to sensitivity (tpr) >= constraint."""
    specificity = 1 - fpr
    mask = tpr >= min_sensitivity
    best = torch.max(torch.where(mask, specificity, -torch.inf))
    any_valid = torch.any(mask)
    best = torch.where(any_valid, best, 0.0)
    idx = torch.argmax(torch.where(mask & (specificity == best), 1, 0))
    thr = torch.where(any_valid, thresholds[idx], 1e6)
    return best, thr


def _sensitivity_at_specificity(
    fpr: Tensor, tpr: Tensor, thresholds: Tensor, min_specificity: float
) -> Tuple[Tensor, Tensor]:
    """Max sensitivity subject to specificity >= constraint."""
    specificity = 1 - fpr
    mask = specificity >= min_specificity
    best = torch.max(torch.where(mask, tpr, -torch.inf))
    any_valid = torch.any(mask)
    best = torch.where(any_valid, best, 0.0)
    idx = torch.argmax(torch.where(mask & (tpr == best), 1, 0))
    thr = torch.where(any_valid, thresholds[idx], 1e6)
    return best, thr


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest specificity with sensitivity >= ``min_sensitivity``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_specificity_at_sensitivity
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> spec, thr = binary_specificity_at_sensitivity(preds, target, min_sensitivity=1.0)
        >>> float(spec)
        1.0
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        if not isinstance(min_sensitivity, float) or not (0 <= min_sensitivity <= 1):
            raise ValueError(
                f"Expected argument `min_sensitivity` to be an float in the [0,1] range, but got {min_sensitivity}"
            )
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    fpr, tpr, thr = _binary_roc_compute(state, thresholds)
    return _specificity_at_sensitivity(fpr, tpr, thr, min_sensitivity)


def binary_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    min_specificity: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest sensitivity with specificity >= ``min_specificity``."""
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        if not isinstance(min_specificity, float) or not (0 <= min_specificity <= 1):
            raise ValueError(
                f"Expected argument `min_specificity` to be an float in the [0,1] range, but got {min_specificity}"
            )
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    fpr, tpr, thr = _binary_roc_compute(state, thresholds)
    return _sensitivity_at_specificity(fpr, tpr, thr, min_specificity)


def _per_class_roc_fixed_op(fpr, tpr, thresholds, num: int, constraint: float, reduce_fn) -> Tuple[Tensor, Tensor]:
    vals, thrs = [], []
    for i in range(num):
        f_i = fpr[i]
        t_i = tpr[i]
        th_i = thresholds if not isinstance(thresholds, list) and thresholds.ndim == 1 else thresholds[i]
        v, t = reduce_fn(f_i, t_i, th_i, constraint)
        vals.append(v)
        thrs.append(t)
    return torch.stack(vals), torch.stack(thrs)


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest specificity with sensitivity >= constraint."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    fpr, tpr, thr = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_class_roc_fixed_op(fpr, tpr, thr, num_classes, min_sensitivity, _specificity_at_sensitivity)


def multiclass_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_specificity: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest sensitivity with specificity >= constraint."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    fpr, tpr, thr = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_class_roc_fixed_op(fpr, tpr, thr, num_classes, min_specificity, _sensitivity_at_specificity)


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest specificity with sensitivity >= constraint."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    fpr, tpr, thr = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_class_roc_fixed_op(fpr, tpr, thr, num_labels, min_sensitivity, _specificity_at_sensitivity)


def multilabel_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_specificity: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest sensitivity with specificity >= constraint."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    fpr, tpr, thr = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_class_roc_fixed_op(fpr, tpr, thr, num_labels, min_specificity, _sensitivity_at_specificity)
