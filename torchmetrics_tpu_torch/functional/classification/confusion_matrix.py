"""Confusion matrices (port of ``torchmetrics_tpu/functional/classification/confusion_matrix.py``).

Below ``_KERNEL_MIN_CLASSES`` the matrix is the kernel's plain version, an
integer ``bincount`` of ``target * C + preds`` (the JAX package's float32
one-hot product rounds past ``2**24`` rows in a cell; the count here is
exact). From there on, :func:`confusion_matrix_cuda` counts it: the
hand-written kernel on a CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._confmat_kernel import confusion_matrix_cuda, confusion_matrix_plain
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _in_compiled_step, _target_set_value_flags
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalize over true/pred/all (reference ``confusion_matrix.py:26-59``)."""
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
        elif normalize == "pred":
            confmat = _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
        elif normalize == "all":
            confmat = _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    return confmat


def _labels_dtype(target: Tensor) -> torch.dtype:
    """int32/int64 labels keep their type (the kernel takes both); anything else becomes int64."""
    return target.dtype if target.dtype in (torch.int32, torch.int64) else torch.int64


# ---------------------------------------------------------------------------
# Binary
# ---------------------------------------------------------------------------


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")


def _binary_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if _in_compiled_step():  # `_binary_confusion_matrix_value_flags` carries it
        return
    unique = set(torch.unique(target).tolist())
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique)} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _binary_confusion_matrix_value_flags(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> Tuple[Tuple[str, ...], Tensor]:
    """The binary check on the device, the target set only (JAX ``confusion_matrix.py:78``)."""
    return _target_set_value_flags(target, ignore_index)


def _binary_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    dtype = _labels_dtype(target)
    if torch.is_floating_point(preds):
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = preds > threshold
    preds = preds.to(dtype)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, 0).to(dtype)
    preds = torch.where(valid, preds, 0)
    return preds, target, valid


_KERNEL_MIN_CLASSES = 256  # below this a bincount is at least as fast


def _confusion_matrix_update(
    preds: Tensor, target: Tensor, valid: Tensor, num_classes: int, out: Optional[Tensor] = None
) -> Tensor:
    """Int32 confusion-matrix counts: rows=true class, cols=pred class.

    Small ``C``: :func:`confusion_matrix_plain`, an integer ``bincount`` of
    ``target * C + preds``, exact at any row count. (The JAX package's
    float32 one-hot product rounds once a cell passes ``2**24`` in one
    update.) Large ``C``: :func:`confusion_matrix_cuda`, the kernel on a
    CUDA tensor. Both take ``valid`` as a bool mask, and a row whose label
    lies outside ``[0, C)`` adds nothing. With ``out`` (a metric's ``(C, C)``
    int32 state) the counts are added into it and it is returned, so no
    fresh matrix is zeroed and no ``+=`` runs beside it.
    """
    count = confusion_matrix_cuda if num_classes >= _KERNEL_MIN_CLASSES else confusion_matrix_plain
    return count(preds.reshape(-1), target.reshape(-1), num_classes, weights=valid.reshape(-1), out=out)


def _binary_confusion_matrix_update(
    preds: Tensor, target: Tensor, valid: Tensor, out: Optional[Tensor] = None
) -> Tensor:
    return _confusion_matrix_update(preds, target, valid, 2, out)


def _binary_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary confusion matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_confusion_matrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> binary_confusion_matrix(preds, target)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, valid)
    return _binary_confusion_matrix_compute(confmat, normalize)


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")


def _multiclass_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim == target.ndim + 1:
        if not torch.is_floating_point(preds):
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
    elif preds.ndim != target.ndim:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should"
                         " be (N, ...) and `preds` should be (N, C, ...).")


def _multiclass_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    if preds.ndim == target.ndim + 1:
        preds = torch.argmax(preds, dim=1)
    dtype = _labels_dtype(target)
    preds = preds.reshape(-1).to(dtype)
    target = target.reshape(-1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, 0).to(dtype)
    preds = torch.where(valid, preds, 0)
    return preds, target, valid


def _multiclass_confusion_matrix_update(
    preds: Tensor, target: Tensor, valid: Tensor, num_classes: int, out: Optional[Tensor] = None
) -> Tensor:
    return _confusion_matrix_update(preds, target, valid, num_classes, out)


def _multiclass_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass confusion matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> multiclass_confusion_matrix(preds, target, num_classes=3)
        tensor([[1, 1, 0],
                [0, 1, 0],
                [0, 0, 1]], dtype=torch.int32)
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, valid, num_classes)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


# ---------------------------------------------------------------------------
# Multilabel
# ---------------------------------------------------------------------------


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")


def _multilabel_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]`={preds.shape[1]} to equal `num_labels`={num_labels}")


def _multilabel_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    if torch.is_floating_point(preds):
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = preds > threshold
    preds = torch.movedim(preds.to(torch.int32), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, 0).to(torch.int32)
    preds = torch.where(valid, preds, 0)
    return preds, target, valid


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, valid: Tensor, num_labels: int) -> Tensor:
    """Per-label 2×2 matrices, shape ``(L, 2, 2)``."""
    tp = ((preds == 1) & (target == 1) & valid).sum(dim=0)
    fp = ((preds == 1) & (target == 0) & valid).sum(dim=0)
    tn = ((preds == 0) & (target == 0) & valid).sum(dim=0)
    fn = ((preds == 0) & (target == 1) & valid).sum(dim=0)
    return torch.stack([tn, fp, fn, tp], dim=-1).reshape(num_labels, 2, 2).to(torch.int32)


def _multilabel_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel confusion matrix: one 2×2 matrix per label."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, valid, num_labels)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task dispatcher for confusion matrix."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_confusion_matrix(
            preds, target, num_labels, threshold, normalize, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
