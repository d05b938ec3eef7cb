"""Matthews correlation coefficient (port of ``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``).

Parity target: reference ``torchmetrics/functional/classification/matthews_corrcoef.py``. The
coefficient is reduced from the confusion matrix in float32, as the JAX package reduces it; from
256 classes on the matrix is counted by the confmat kernel on a GPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """Generalized MCC from a confusion matrix, with the reference's edge cases (JAX ``matthews_corrcoef.py:28-64``).

    The sums and products run in float32, as in the JAX package. The 2x2
    degenerate cases are selected with ``torch.where``, so nothing is read
    back to the host.
    """
    # multilabel: sum the per-label 2x2 matrices into one
    if confmat.ndim == 3:
        confmat = confmat.sum(dim=0)
    confmat = confmat.to(torch.float32)
    tk = confmat.sum(dim=1)
    pk = confmat.sum(dim=0)
    c = torch.trace(confmat)
    s = confmat.sum()

    cov_ytyp = c * s - torch.dot(tk, pk)
    cov_ypyp = s**2 - torch.dot(pk, pk)
    cov_ytyt = s**2 - torch.dot(tk, tk)

    numerator = cov_ytyp
    denom = cov_ypyp * cov_ytyt

    if confmat.shape[0] == 2:
        tn, fp, fn, tp = confmat.reshape(-1)
        eps = torch.finfo(torch.float32).eps
        degenerate = (denom == 0) & (
            ((tp == 0) & (fn == 0)) | ((tp == 0) & (fp == 0)) | ((tn == 0) & (fn == 0)) | ((tn == 0) & (fp == 0))
        )
        numerator = torch.where(degenerate, tp * tn - fp * fn, numerator)
        denom = torch.where(degenerate, (tp + fp + eps) * (tp + fn + eps) * (tn + fp + eps) * (tn + fn + eps), denom)
    zero = denom == 0
    return torch.where(zero, torch.zeros_like(numerator), numerator / torch.sqrt(torch.where(zero, 1.0, denom)))


def binary_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_matthews_corrcoef
        >>> binary_matthews_corrcoef(torch.tensor([0.35, 0.85, 0.48, 0.01]), torch.tensor([1, 1, 0, 0]))
        tensor(0.5774)
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, valid)
    return _matthews_corrcoef_reduce(confmat)


def multiclass_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for multiclass tasks."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, valid, num_classes)
    return _matthews_corrcoef_reduce(confmat)


def multilabel_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for multilabel tasks."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, valid, num_labels)
    return _matthews_corrcoef_reduce(confmat)


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching MCC."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
