"""Stat-scores (tp/fp/tn/fn): the root of the classification domain.

Port of ``torchmetrics_tpu/functional/classification/stat_scores.py`` (parity
target: reference ``torchmetrics/functional/classification/stat_scores.py``).
Per-class counts are reductions over one-hot products, as in the JAX package,
which has no kernel behind them; ``ignore_index`` masks rows instead of
dropping them, so every shape is fixed by the input's shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _one_hot, select_topk
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

_ALLOWED_MULTIDIM_AVERAGE = ("global", "samplewise")
_ALLOWED_AVERAGE = ("micro", "macro", "weighted", "none", None)


def _check_multidim_average(multidim_average: str) -> None:
    if multidim_average not in _ALLOWED_MULTIDIM_AVERAGE:
        raise ValueError(
            f"Expected argument `multidim_average` to be one of {_ALLOWED_MULTIDIM_AVERAGE},"
            f" but got {multidim_average}"
        )


def _check_ignore_index(ignore_index: Optional[int]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _count(hit: Tensor, dim) -> Tensor:
    return hit.sum(dim=dim).to(torch.int32)


# ---------------------------------------------------------------------------
# Binary
# ---------------------------------------------------------------------------


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _check_multidim_average(multidim_average)
    _check_ignore_index(ignore_index)


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if torch.is_floating_point(target):
        raise ValueError("Expected argument `target` to be an int tensor, but got tensor with float dtype.")
    unique = torch.unique(target).tolist()
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not set(unique).issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {unique} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not torch.is_floating_point(preds):
        unique_p = torch.unique(preds).tolist()
        if not set(unique_p).issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {unique_p} but expected only"
                " binary values [0, 1] for integer predictions."
            )
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")


def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Normalize inputs → (preds01, target01, valid_mask); labels int32, same shape."""
    if torch.is_floating_point(preds):
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = preds > threshold
    preds = preds.to(torch.int32)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, 0).to(torch.int32)
    preds = torch.where(valid, preds, 0)
    return preds, target, valid


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Count tp/fp/tn/fn. ``samplewise`` keeps the leading sample axis."""
    if multidim_average == "global":
        dim = None
        preds, target, valid = preds.reshape(-1), target.reshape(-1), valid.reshape(-1)
    else:
        dim = 1
        preds = preds.reshape(preds.shape[0], -1)
        target = target.reshape(target.shape[0], -1)
        valid = valid.reshape(valid.shape[0], -1)
    tp = _count((preds == 1) & (target == 1) & valid, dim)
    fp = _count((preds == 1) & (target == 0) & valid, dim)
    tn = _count((preds == 0) & (target == 0) & valid, dim)
    fn = _count((preds == 0) & (target == 1) & valid, dim)
    return tp, fp, tn, fn


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    """Stack to ``[tp, fp, tn, fn, support]`` (reference output layout)."""
    stats = [tp, fp, tn, fn, tp + fn]
    return torch.stack(stats, dim=0) if multidim_average == "global" else torch.stack(stats, dim=-1)


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute true/false positives/negatives for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_stat_scores
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> binary_stat_scores(preds, target)
        tensor([2, 1, 2, 1, 3], dtype=torch.int32)
    """
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, valid, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not (isinstance(top_k, int) and top_k >= 1):
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"Expected argument `average` to be one of {_ALLOWED_AVERAGE}, but got {average}")
    _check_multidim_average(multidim_average)
    _check_ignore_index(ignore_index)


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not torch.is_floating_point(preds):
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("Expected input to be at least 2D when multidim_average is set to `samplewise`")
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    t = target if ignore_index is None else target[target != ignore_index]
    if t.numel() and bool((t.min() < 0) | (t.max() >= num_classes)):
        raise RuntimeError(f"Detected more unique values in `target` than expected. Expected only {num_classes}.")
    if not torch.is_floating_point(preds) and preds.numel() and bool((preds.min() < 0) | (preds.max() >= num_classes)):
        raise RuntimeError(f"Detected more unique values in `preds` than expected. Expected only {num_classes}.")


def _multiclass_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    top_k: int = 1,
) -> Tuple[Tensor, Tensor]:
    """Probabilities/logits → labels (top-1) or kept as scores for top-k."""
    if torch.is_floating_point(preds) and preds.ndim == target.ndim + 1 and top_k == 1:
        preds = torch.argmax(preds, dim=1)
    return preds, target


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class tp/fp/tn/fn via one-hot algebra; global → ``(C,)``, samplewise → ``(N, C)``.

    The per-class layout is kept regardless of ``average`` (micro sums at
    compute time), so metric states have one shape for every configuration.
    """
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target_c = torch.where(valid, target, 0)

    if preds.ndim == target.ndim + 1:
        # scores (N, C, ...) → top-k one-hot along axis 1
        preds_oh = select_topk(preds, topk=top_k, dim=1)
    else:
        preds_oh = torch.movedim(_one_hot(preds.long(), num_classes), -1, 1)
    target_oh = torch.movedim(_one_hot(target_c, num_classes), -1, 1)

    # zero out ignored samples in both encodings
    mask = valid.unsqueeze(1)
    preds_oh = preds_oh * mask
    target_oh = target_oh * mask

    if multidim_average == "global":
        # flatten all sample dims: (N, C, ...) → (C, total)
        po = torch.movedim(preds_oh, 1, 0).reshape(num_classes, -1)
        to = torch.movedim(target_oh, 1, 0).reshape(num_classes, -1)
        dim = 1
        total_valid = valid.sum()
    else:
        n = preds_oh.shape[0]
        po = preds_oh.reshape(n, num_classes, -1)
        to = target_oh.reshape(n, num_classes, -1)
        dim = 2
        total_valid = valid.reshape(n, -1).sum(dim=1, keepdim=True)
    tp = _count(po * to, dim)
    fp = _count(po * (1 - to), dim)
    fn = _count((1 - po) * to, dim)
    # tn must not count ignored samples: total valid - tp - fp - fn per class
    tn = (total_valid - tp - fp - fn).to(torch.int32)
    return tp, fp, tn, fn


def _stat_scores_average(res: Tensor, tp: Tensor, fn: Tensor, average: Optional[str], sum_axis: int) -> Tensor:
    """Shared micro/macro/weighted reduction of the stacked [tp,fp,tn,fn,sup] layout."""
    if average == "micro":
        return res.sum(dim=sum_axis)
    if average == "macro":
        return res.to(torch.float32).mean(dim=sum_axis)
    if average == "weighted":
        # support-weighted sum over the class axis (reference stat_scores.py:441-445)
        w = (tp + fn).to(torch.float32)
        frac = _safe_divide(w, w.sum(dim=sum_axis, keepdim=True).expand_as(w))
        return (res.to(torch.float32) * frac[..., None]).sum(dim=sum_axis)
    return res


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    """Reduce per-class counts per ``average`` (reference output layout)."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_axis = 0 if multidim_average == "global" else 1
    return _stat_scores_average(res, tp, fn, average, sum_axis)


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute per-class tp/fp/tn/fn for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_stat_scores
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> multiclass_stat_scores(preds, target, num_classes=3, average='micro')
        tensor([3, 1, 7, 1, 4])
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ---------------------------------------------------------------------------
# Multilabel
# ---------------------------------------------------------------------------


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float, but got {threshold}.")
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"Expected argument `average` to be one of {_ALLOWED_AVERAGE}, but got {average}")
    _check_multidim_average(multidim_average)
    _check_ignore_index(ignore_index)


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be at least 3D when multidim_average is set to `samplewise`")


def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    if torch.is_floating_point(preds):
        preds = normalize_logits_if_needed(preds, "sigmoid")
        preds = preds > threshold
    preds = preds.to(torch.int32)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, 0).to(torch.int32)
    preds = torch.where(valid, preds, 0)
    return preds, target, valid


def _multilabel_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-label counts; global → ``(L,)``, samplewise → ``(N, L)``."""
    if multidim_average == "global":
        # (N, L, ...) → reduce over sample + extra dims, keep label axis
        dim = tuple(i for i in range(preds.ndim) if i != 1)
    else:
        dim = tuple(range(2, preds.ndim))
    tp = _count((preds == 1) & (target == 1) & valid, dim)
    fp = _count((preds == 1) & (target == 0) & valid, dim)
    tn = _count((preds == 0) & (target == 0) & valid, dim)
    fn = _count((preds == 0) & (target == 1) & valid, dim)
    return tp, fp, tn, fn


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: Optional[str] = "macro", multidim_average: str = "global"
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_axis = 0 if multidim_average == "global" else 1
    return _stat_scores_average(res, tp, fn, average, sum_axis)


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute per-label tp/fp/tn/fn for multilabel tasks."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, valid, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ---------------------------------------------------------------------------
# Task dispatcher
# ---------------------------------------------------------------------------


def stat_scores(
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
    """Task-dispatching stat scores (reference ``stat_scores.py`` public dispatcher)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_stat_scores(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
