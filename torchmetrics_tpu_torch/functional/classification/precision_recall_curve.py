"""Precision-recall curves (port of ``torchmetrics_tpu/functional/classification/precision_recall_curve.py``).

Parity target: reference ``torchmetrics/functional/classification/precision_recall_curve.py``.
Two state modes:

- ``thresholds=None``: the exact curve. The update passes ``(preds, target)``
  through (cat states); ``compute`` sorts and takes cumulative sums, so its
  output length depends on the data and reads counts back to the host.
- ``thresholds=int/list/tensor``: binned. The update counts a fixed-shape
  ``(T, 2, 2)`` (or ``(T, C, 2, 2)``) int32 confusion tensor from one
  broadcast compare of the scores with the thresholds, ``(N, T)`` (or
  ``(N, C, T)``) booleans, and sums it into the state.

An integer ``thresholds`` gives ``T`` points evenly spaced over ``[0, 1]``,
computed as ``jax.numpy.linspace`` computes them, so both packages bin on the
same float32 values.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _in_compiled_step
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, interp, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import _one_hot
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask

Thresholds = Optional[Union[int, List[float], Tensor]]
CurveState = Union[Tensor, Tuple[Tensor, Tensor]]


def _binary_clf_curve(preds: Tensor, target: Tensor, pos_label: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """fps, tps and the score at each distinct threshold, scores descending.

    The sort is stable, as the JAX package's ``argsort(-preds, stable=True)``,
    so tied scores give the same thresholds. The output length depends on
    the data: one host read.
    """
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc = torch.argsort(-preds, stable=True)
    preds = preds[desc]
    target = target[desc]
    distinct = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    threshold_idxs = torch.cat([distinct, torch.tensor([target.shape[0] - 1], device=preds.device)])
    tps = torch.cumsum((target == pos_label).to(torch.int32), dim=0, dtype=torch.int32)[threshold_idxs]
    fps = 1 + threshold_idxs.to(torch.int32) - tps
    return fps, tps, preds[threshold_idxs]


def _adjust_threshold_arg(thresholds: Thresholds = None, device: Optional[torch.device] = None) -> Optional[Tensor]:
    """The thresholds argument as a 1-D float32 tensor on ``device`` (or None).

    An integer ``T`` gives ``T`` points over ``[0, 1]`` as ``jax.numpy.linspace``
    computes them in float32 (``i * (1 / (T - 1))``, then 1), which
    ``torch.linspace`` does not match to the last bit.
    """
    if isinstance(thresholds, int):
        step = torch.tensor(1.0) / torch.tensor(float(thresholds - 1))
        grid = torch.cat([torch.arange(thresholds - 1, dtype=torch.float32) * step, torch.ones(1)])
        return grid.to(device)
    if isinstance(thresholds, list):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if isinstance(thresholds, Tensor) and device is not None:
        return thresholds.to(device)
    return thresholds


def _binary_precision_recall_curve_arg_validation(thresholds: Thresholds = None, ignore_index: Optional[int] = None) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, int, Tensor)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(
            f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}"
        )
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            "If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, Tensor) and thresholds.ndim != 1:
        raise ValueError("If argument `thresholds` is an tensor, expected the tensor to be 1d")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if torch.is_floating_point(target):
        raise ValueError(
            "Expected argument `target` to be an int or long tensor with ground truth labels"
            f" but got tensor with dtype {target.dtype}"
        )
    if not torch.is_floating_point(preds):
        raise ValueError(
            "Expected argument `preds` to be an floating tensor with probability/logit scores,"
            f" but got tensor with dtype {preds.dtype}"
        )
    if _in_compiled_step():  # the class's `_traced_value_flags` carries the target-set check
        return
    unique = set(torch.unique(target).tolist())
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique)} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    preds = normalize_logits_if_needed(preds, "sigmoid")
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _confmat_2x2(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, dim: int) -> Tensor:
    """int32 ``[target, pred]`` 2x2 blocks (tn=[0,0], fp=[0,1], fn=[1,0], tp=[1,1]) stacked on ``dim``."""
    return torch.stack([torch.stack([tn, fp], dim=-1), torch.stack([fn, tp], dim=-1)], dim=dim).to(torch.int32)


def _binary_precision_recall_curve_update(preds: Tensor, target: Tensor, thresholds: Optional[Tensor]) -> CurveState:
    """``(preds, target)`` in exact mode, else the ``(T, 2, 2)`` int32 binned counts of this batch."""
    if thresholds is None:
        return preds, target
    preds_t = preds[:, None] >= thresholds[None, :]  # (N, T)
    target_b = (target == 1)[:, None]
    tp = (preds_t & target_b).sum(0)
    fp = (preds_t & ~target_b).sum(0)
    fn = (~preds_t & target_b).sum(0)
    tn = target.shape[0] - tp - fp - fn
    return _confmat_2x2(tp, fp, tn, fn, dim=1)


def _binary_precision_recall_curve_compute(
    state: CurveState, thresholds: Optional[Tensor], pos_label: int = 1
) -> Tuple[Tensor, Tensor, Tensor]:
    if thresholds is not None and not isinstance(state, tuple):
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        return precision, recall, thresholds

    fps, tps, thresh = _binary_clf_curve(state[0], state[1], pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    precision = torch.cat([precision.flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall.flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresh.flip(0)


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall curve for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_precision_recall_curve
        >>> preds = torch.tensor([0.0, 0.5, 0.7, 0.8])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = binary_precision_recall_curve(preds, target, thresholds=5)
        >>> precision
        tensor([0.5000, 0.6667, 0.6667, 0.0000, 0.0000, 1.0000])
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_precision_recall_curve_compute(state, thresholds)


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average is not None and average not in ("micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if not torch.is_floating_point(preds):
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of classes")
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError("Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be (N, ...).")


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)  # (N, C, ...) -> (N*, C)
    target = target.reshape(-1)
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    preds = normalize_logits_if_needed(preds, "softmax")
    if average == "micro":
        preds = preds.reshape(-1)
        target = _one_hot(target, num_classes).reshape(-1)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> CurveState:
    """``(preds, target)`` in exact mode, else the ``(T, C, 2, 2)`` int32 binned counts of this batch.

    The compare is one ``(N, C, T)`` bool tensor: 102 MB at N 1024, C 1000, T 100.
    """
    if thresholds is None:
        return preds, target
    if average == "micro":
        return _binary_precision_recall_curve_update(preds, target, thresholds)
    preds_t = preds[:, :, None] >= thresholds[None, None, :]  # (N, C, T)
    target_oh = _one_hot(target, num_classes, torch.bool)[:, :, None]  # (N, C, 1)
    tp = (preds_t & target_oh).sum(0)  # (C, T)
    fp = (preds_t & ~target_oh).sum(0)
    fn = (~preds_t & target_oh).sum(0)
    tn = target.shape[0] - tp - fp - fn
    return _confmat_2x2(tp, fp, tn, fn, dim=-2).movedim(1, 0)  # (T, C, 2, 2), [t, c, target, pred]


def _multiclass_precision_recall_curve_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Per-class curves; exact mode loops over the classes, one host read each."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)

    if thresholds is not None and not isinstance(state, tuple):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        ones = torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)
        precision = torch.cat([precision, ones]).T
        recall = torch.cat([recall, torch.zeros_like(ones)]).T
        thres = thresholds
        tensor_state = True
    else:
        precision_list, recall_list, thres_list = [], [], []
        for i in range(num_classes):
            res = _binary_precision_recall_curve_compute((state[0][:, i], state[1]), None, pos_label=i)
            precision_list.append(res[0])
            recall_list.append(res[1])
            thres_list.append(res[2])
        tensor_state = False

    if average == "macro":
        thres = thres.repeat(num_classes) if tensor_state else torch.cat(thres_list, 0)
        thres = torch.sort(thres).values
        mean_precision = precision.reshape(-1) if tensor_state else torch.cat(precision_list, 0)
        mean_precision = torch.sort(mean_precision).values
        mean_recall = torch.zeros_like(mean_precision)
        for i in range(num_classes):
            mean_recall = mean_recall + interp(
                mean_precision,
                precision[i] if tensor_state else precision_list[i],
                recall[i] if tensor_state else recall_list[i],
            )
        mean_recall = mean_recall / num_classes
        return mean_precision, mean_recall, thres

    if tensor_state:
        return precision, recall, thres
    return precision_list, recall_list, thres_list


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall curve for multiclass tasks (one-vs-rest)."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, average)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# ---------------------------------------------------------------------------
# Multilabel
# ---------------------------------------------------------------------------


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError("Expected `preds.shape[1]` to be equal to the number of labels")
    if not torch.is_floating_point(preds):
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    if ignore_index is not None and thresholds is None:
        # exact mode: mark ignored positions with an out-of-range sentinel
        preds = torch.where(target == ignore_index, -1000.0, preds)
    return preds, target, thresholds


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> CurveState:
    if thresholds is None:
        return preds, target
    preds_t = preds[:, :, None] >= thresholds[None, None, :]  # (N, L, T)
    target_b = (target == 1)[:, :, None]
    valid = torch.ones_like(target_b) if ignore_index is None else (target != ignore_index)[:, :, None]
    tp = (preds_t & target_b & valid).sum(0)
    fp = (preds_t & ~target_b & valid).sum(0)
    fn = (~preds_t & target_b & valid).sum(0)
    tn = (~preds_t & ~target_b & valid).sum(0)
    return _confmat_2x2(tp, fp, tn, fn, dim=-2).movedim(1, 0)


def _multilabel_precision_recall_curve_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if thresholds is not None and not isinstance(state, tuple):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        ones = torch.ones((1, num_labels), dtype=precision.dtype, device=precision.device)
        precision = torch.cat([precision, ones]).T
        recall = torch.cat([recall, torch.zeros_like(ones)]).T
        return precision, recall, thresholds

    precision_list, recall_list, thres_list = [], [], []
    for i in range(num_labels):
        preds_i = state[0][:, i]
        target_i = state[1][:, i]
        if ignore_index is not None:
            keep = target_i != ignore_index
            preds_i, target_i = preds_i[keep], target_i[keep]
        res = _binary_precision_recall_curve_compute((preds_i, target_i), None, pos_label=1)
        precision_list.append(res[0])
        recall_list.append(res[1])
        thres_list.append(res[2])
    return precision_list, recall_list, thres_list


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall curve for multilabel tasks (per label)."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Task-dispatching precision-recall curve."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_precision_recall_curve(
            preds, target, num_classes, thresholds, average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
