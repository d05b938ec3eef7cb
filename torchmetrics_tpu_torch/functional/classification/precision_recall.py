"""Precision and recall (port of ``torchmetrics_tpu/functional/classification/precision_recall.py``).

Parity target: reference ``torchmetrics/functional/classification/precision_recall.py``. Each
metric is the stat-scores pipeline of ``_derived.py`` followed by its own reduction.
"""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._derived import _binary_stats, _multiclass_stats, _multilabel_stats
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


def _precision_recall_reduce(
    stat: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0.0,
) -> Tensor:
    """Reference ``precision_recall.py:26-60``."""
    different_stat = fp if stat == "precision" else fn  # this is what differs between the two scores
    if average == "binary":
        return _safe_divide(tp, tp + different_stat, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = tp.sum(dim=dim)
        different_stat = different_stat.sum(dim=dim)
        return _safe_divide(tp, tp + different_stat, zero_division)
    score = _safe_divide(tp, tp + different_stat, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, zero_division)


def binary_precision(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Binary precision.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_precision
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> binary_precision(preds, target)
        tensor(0.6667)
    """
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce(
        "precision", tp, fp, tn, fn, average="binary", multidim_average=multidim_average, zero_division=zero_division
    )


def multiclass_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Multiclass precision."""
    tp, fp, tn, fn = _multiclass_stats(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(
        "precision", tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k,
        zero_division=zero_division,
    )


def multilabel_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Multilabel precision."""
    tp, fp, tn, fn = _multilabel_stats(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(
        "precision", tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True,
        zero_division=zero_division,
    )


def binary_recall(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Binary recall.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_recall
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> binary_recall(preds, target)
        tensor(0.6667)
    """
    tp, fp, tn, fn = _binary_stats(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce(
        "recall", tp, fp, tn, fn, average="binary", multidim_average=multidim_average, zero_division=zero_division
    )


def multiclass_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Multiclass recall."""
    tp, fp, tn, fn = _multiclass_stats(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(
        "recall", tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k,
        zero_division=zero_division,
    )


def multilabel_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Multilabel recall."""
    tp, fp, tn, fn = _multilabel_stats(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(
        "recall", tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True,
        zero_division=zero_division,
    )


def precision(
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
    zero_division: float = 0.0,
) -> Tensor:
    """Task dispatcher for precision."""
    from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision(preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_precision(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_precision(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
        )
    raise ValueError(f"Not handled value: {task}")


def recall(
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
    zero_division: float = 0.0,
) -> Tensor:
    """Task dispatcher for recall."""
    from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_recall(preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_recall(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, zero_division
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_recall(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, zero_division
        )
    raise ValueError(f"Not handled value: {task}")
