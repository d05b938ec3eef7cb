"""Recall at fixed precision and precision at fixed recall (port of
``torchmetrics_tpu/functional/classification/recall_fixed_precision.py``; reference
``functional/classification/{recall_fixed_precision,precision_fixed_recall}.py``).

The best operating point is picked on the device with ``torch.where``: ties go to the
highest recall, then the highest precision; the threshold is ``1e6`` where the best value is 0.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)


def _recall_at_precision(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    """Max recall subject to precision >= min_precision (+ the achieving threshold)."""
    zipped_len = min(recall.shape[0], precision.shape[0], thresholds.shape[0])
    r, p, t = recall[:zipped_len], precision[:zipped_len], thresholds[:zipped_len]
    mask = p >= min_precision
    max_recall = torch.max(torch.where(mask, r, -torch.inf))
    any_valid = torch.any(mask)
    max_recall = torch.where(any_valid, max_recall, 0.0)
    # among points hitting max recall with precision ok, pick the one the
    # reference's lexicographic argmax picks (max recall, then max precision)
    tie = mask & (r == max_recall)
    p_best = torch.max(torch.where(tie, p, -torch.inf))
    tie2 = tie & (p == p_best)
    idx = torch.argmax(tie2.to(torch.int32))
    best_threshold = torch.where(any_valid, t[idx], 0.0)
    best_threshold = torch.where(max_recall == 0.0, 1e6, best_threshold)
    return max_recall, best_threshold


def _precision_at_recall(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_recall: float,
) -> Tuple[Tensor, Tensor]:
    """Max precision subject to recall >= min_recall."""
    zipped_len = min(recall.shape[0], precision.shape[0], thresholds.shape[0])
    r, p, t = recall[:zipped_len], precision[:zipped_len], thresholds[:zipped_len]
    mask = r >= min_recall
    max_precision = torch.max(torch.where(mask, p, -torch.inf))
    any_valid = torch.any(mask)
    max_precision = torch.where(any_valid, max_precision, 0.0)
    tie = mask & (p == max_precision)
    r_best = torch.max(torch.where(tie, r, -torch.inf))
    idx = torch.argmax((tie & (r == r_best)).to(torch.int32))
    best_threshold = torch.where(any_valid, t[idx], 0.0)
    best_threshold = torch.where(max_precision == 0.0, 1e6, best_threshold)
    return max_precision, best_threshold


def _binary_fixed_op_compute(
    state,
    thresholds: Optional[Tensor],
    constraint: float,
    reduce_fn: Callable,
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds)
    return reduce_fn(precision, recall, thresholds, constraint)


def binary_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    min_precision: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest recall achievable with precision >= ``min_precision``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_recall_at_fixed_precision
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.8])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> recall, threshold = binary_recall_at_fixed_precision(preds, target, min_precision=1.0)
        >>> float(recall)
        1.0
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        if not isinstance(min_precision, float) or not (0 <= min_precision <= 1):
            raise ValueError(
                f"Expected argument `min_precision` to be an float in the [0,1] range, but got {min_precision}"
            )
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_fixed_op_compute(state, thresholds, min_precision, _recall_at_precision)


def binary_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    min_recall: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest precision achievable with recall >= ``min_recall``."""
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        if not isinstance(min_recall, float) or not (0 <= min_recall <= 1):
            raise ValueError(f"Expected argument `min_recall` to be an float in the [0,1] range, but got {min_recall}")
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_fixed_op_compute(state, thresholds, min_recall, _precision_at_recall)


def _per_class_fixed_op(
    precision, recall, thresholds, num: int, constraint: float, reduce_fn: Callable
) -> Tuple[Tensor, Tensor]:
    vals, thrs = [], []
    for i in range(num):
        p_i = precision[i]
        r_i = recall[i]
        t_i = thresholds if not isinstance(thresholds, list) and thresholds.ndim == 1 else thresholds[i]
        v, t = reduce_fn(p_i, r_i, t_i, constraint)
        vals.append(v)
        thrs.append(t)
    return torch.stack(vals), torch.stack(thrs)


def multiclass_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest recall with precision >= ``min_precision``."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_class_fixed_op(precision, recall, thresholds, num_classes, min_precision, _recall_at_precision)


def multiclass_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest precision with recall >= ``min_recall``."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_class_fixed_op(precision, recall, thresholds, num_classes, min_recall, _precision_at_recall)


def multilabel_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest recall with precision >= ``min_precision``."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    precision, recall, thresholds = _multilabel_precision_recall_curve_compute(
        state, num_labels, thresholds, ignore_index
    )
    return _per_class_fixed_op(precision, recall, thresholds, num_labels, min_precision, _recall_at_precision)


def multilabel_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Optional[Union[int, List[float], Tensor]] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest precision with recall >= ``min_recall``."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    precision, recall, thresholds = _multilabel_precision_recall_curve_compute(
        state, num_labels, thresholds, ignore_index
    )
    return _per_class_fixed_op(precision, recall, thresholds, num_labels, min_recall, _precision_at_recall)
