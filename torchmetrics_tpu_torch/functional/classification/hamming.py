"""Hamming distance (port of ``torchmetrics_tpu/functional/classification/hamming.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._derived import _binary_stats, _multiclass_stats, _multilabel_stats
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


def _hamming_distance_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> Tensor:
    """``1 - accuracy`` per the reference reduction (``hamming.py:22-76``)."""
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=axis)
        fn = torch.sum(fn, dim=axis)
        if multilabel:
            fp = torch.sum(fp, dim=axis)
            tn = torch.sum(tn, dim=axis)
            return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
        return 1 - _safe_divide(tp, tp + fn)
    score = 1 - _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else 1 - _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def binary_hamming_distance(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary Hamming distance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_hamming_distance
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> binary_hamming_distance(preds, target)
        tensor(0.3333)
    """
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_hamming_distance(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass Hamming distance."""
    tp, fp, tn, fn = _multiclass_stats(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _hamming_distance_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)


def multilabel_hamming_distance(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel Hamming distance."""
    tp, fp, tn, fn = _multilabel_stats(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _hamming_distance_reduce(
        tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True
    )


def hamming_distance(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher for Hamming distance."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_hamming_distance(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_hamming_distance(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_hamming_distance(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
