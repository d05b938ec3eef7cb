"""Dice score (port of ``torchmetrics_tpu/functional/classification/dice.py``).

Dice = 2·tp / (2·tp + fp + fn), computed over the reference's *legacy*
classification pipeline: case detection, legacy input formatting to int32
one-hot ``(N, C[, X])`` tensors, legacy stat scores with
``reduce``/``mdmc_reduce`` and ``_reduce_stat_scores`` (reference
``utilities/checks.py:75-456``, ``functional/classification/stat_scores.py:861-1074``).
The case is picked on the host, from shapes, dtypes and a few host reads of
label maxima, as in the JAX package; the tensor math runs on the inputs'
device. The one-hot temporaries are ``N·C·X`` int32 elements each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import select_topk, to_onehot

_MC_CASES = ("multi-class", "multi-dim multi-class")


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Remove excess size-1 dims, keeping the batch dim (reference ``checks.py:303-312``)."""
    if preds.shape[0] == 1:
        return torch.squeeze(preds)[None], torch.squeeze(target)[None]
    return torch.squeeze(preds), torch.squeeze(target)


def _legacy_case(preds: Tensor, target: Tensor) -> str:
    preds_float = torch.is_floating_point(preds)
    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape")
        if preds_float and target.numel() and int(target.max()) > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1:
            return "binary" if preds_float else "multi-class"
        return "multi-label" if preds_float else "multi-dim multi-class"
    if preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        return "multi-class" if preds.ndim == 2 else "multi-dim multi-class"
    raise ValueError(
        "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
        " and `preds` should be (N, C, ...)."
    )


def _check_legacy_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int],
    case: str,
) -> None:
    """Legacy input consistency checks (reference ``checks.py:47-300``), on the host."""
    if not (preds.numel() and target.numel()):
        return
    preds_float = torch.is_floating_point(preds)
    tmax = int(target.max())
    # basic validation (reference ``checks.py:47-72``)
    if torch.is_floating_point(target):
        raise ValueError("The `target` has to be an integer tensor.")
    tmin = int(target.min())
    if (ignore_index is None and tmin < 0) or (ignore_index is not None and ignore_index >= 0 and tmin < 0):
        raise ValueError("The `target` has to be a non-negative tensor.")
    if not preds_float and int(preds.min()) < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if preds.shape[0] != target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    if multiclass is False and tmax > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and int(preds.max()) > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")

    if preds.shape == target.shape:
        implied_classes = preds[0].numel() if preds.ndim > 1 else 1
    else:
        implied_classes = preds.shape[1] if preds.ndim > 1 else 0
    # C-dimension consistency (reference ``checks.py:277-288``)
    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if tmax >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )
    # num_classes consistency (reference ``checks.py:131-186,290-294``)
    if num_classes:
        if case == "binary":
            if num_classes > 2:
                raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
            if num_classes == 2 and not multiclass:
                raise ValueError("Your data is binary and `num_classes=2`, but `multiclass` is not True.")
            if num_classes == 1 and multiclass:
                raise ValueError("You have binary data and have set `multiclass=True`, but `num_classes` is 1.")
        elif case in _MC_CASES:
            if num_classes == 1 and multiclass is not False:
                raise ValueError("You have set `num_classes=1`, but predictions are integers.")
            if num_classes > 1:
                if multiclass is False and implied_classes != num_classes:
                    raise ValueError(
                        "You have set `multiclass=False`, but the implied number of classes "
                        " (from shape of inputs) does not match `num_classes`."
                    )
                if num_classes <= tmax:
                    raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
                if preds.shape != target.shape and num_classes != implied_classes:
                    raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")
        elif case == "multi-label":
            if multiclass and num_classes != 2:
                raise ValueError("Your have set `multiclass=True`, but `num_classes` is not equal to 2.")
            if not multiclass and num_classes != implied_classes:
                raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")
    # top_k consistency (reference ``checks.py:189-204``)
    if top_k is not None:
        if case == "binary":
            raise ValueError("You can not use `top_k` parameter with binary data.")
        if not isinstance(top_k, int) or top_k <= 0:
            raise ValueError("The `top_k` has to be an integer larger than 0.")
        if not preds_float:
            raise ValueError("You have set `top_k`, but you do not have probability predictions.")
        if multiclass is False:
            raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
        if case == "multi-label" and multiclass:
            raise ValueError(
                "If you want to transform multi-label data to 2 class multi-dimensional"
                "multi-class data using `multiclass=True`, you can not use `top_k`."
            )
        if top_k >= implied_classes:
            raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _legacy_input_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, str]:
    """Legacy formatter to int32 ``(N, C)`` or ``(N, C, X)`` tensors (reference ``checks.py:315-456``)."""
    preds, target = _input_squeeze(preds, target)
    case = _legacy_case(preds, target)
    _check_legacy_inputs(preds, target, threshold, num_classes, multiclass, top_k, ignore_index, case)

    if case in ("binary", "multi-label") and not top_k:
        preds = (preds >= threshold).to(torch.int32)
        num_classes = num_classes if not multiclass else 2
    if case == "multi-label" and top_k:
        preds = select_topk(preds, top_k)

    if case in _MC_CASES or multiclass:
        if torch.is_floating_point(preds):
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            if num_classes is None:
                num_classes = max(int(preds.max()), int(target.max())) + 1
            preds = to_onehot(preds, max(2, num_classes))
        target = to_onehot(target, max(2, num_classes or 2))
        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if preds.numel() and target.numel():
        if (case in _MC_CASES and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)
    return preds.to(torch.int32), target.to(torch.int32), case


def _legacy_stat_scores(preds: Tensor, target: Tensor, reduce: str) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn sums over the reduce-specific axes (reference ``stat_scores.py:861-906``)."""
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    else:  # "samples"
        dim = 1
    true_pred, false_pred = target == preds, target != preds
    pos_pred, neg_pred = preds == 1, preds == 0
    tp = (true_pred & pos_pred).sum(dim=dim, dtype=torch.int32)
    fp = (false_pred & pos_pred).sum(dim=dim, dtype=torch.int32)
    tn = (true_pred & neg_pred).sum(dim=dim, dtype=torch.int32)
    fn = (false_pred & neg_pred).sum(dim=dim, dtype=torch.int32)
    return tp, fp, tn, fn


def _del_column(t: Tensor, idx: int) -> Tensor:
    return torch.cat([t[:, :idx], t[:, idx + 1 :]], dim=1)


def _legacy_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Legacy update (reference ``stat_scores.py:909-996``): format, mdmc flatten, ignore_index, sums."""
    preds, target, _case = _legacy_input_format(
        preds,
        target,
        threshold=threshold,
        top_k=top_k,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = torch.transpose(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.transpose(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _legacy_stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro":
        tp[..., ignore_index] = -1
        fp[..., ignore_index] = -1
        tn[..., ignore_index] = -1
        fn[..., ignore_index] = -1
    return tp, fp, tn, fn


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: float = 0.0,
) -> Tensor:
    """Score reduction with zero-division and negative-denominator masking (reference ``:1021-1074``)."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0
    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)
    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)
    if average not in ("micro", "none", None):
        # a fully ignored row (every class absent under macro) contributes 0, as the
        # reference's sum over an empty tensor does; only that case: a zero weight sum
        # with live classes (weighted average) keeps the reference's NaN -> zero_division
        all_ignored = ignore_mask.all(dim=-1, keepdim=True)
        weights = torch.where(
            all_ignored, 0.0, weights / torch.where(all_ignored, 1.0, weights.sum(dim=-1, keepdim=True))
        )
    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)
    if mdmc_average == "samplewise" and scores.ndim > 0:
        scores = scores.mean(dim=0)
        ignore_mask = ignore_mask.sum(dim=0).to(torch.bool)
    if average in ("none", None):
        return torch.where(ignore_mask, float("nan"), scores)
    return scores.sum()


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    zero_division: float = 0.0,
) -> Tensor:
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn
    if average == "macro" and mdmc_average != "samplewise":
        # absent classes (no tp/fp/fn) drop out of the macro mean: the negative-denominator
        # ignore mask stands for the reference's boolean indexing, at a fixed shape
        cond = (tp + fp + fn == 0) | (tp < 0)
        numerator = torch.where(cond, -1, numerator)
        denominator = torch.where(cond, -1, denominator)
    if average in ("none", None) and mdmc_average != "samplewise":
        cond = ((tp | fn | fp) == 0) | (tp < 0)
        numerator = torch.where(cond, -1, numerator)
        denominator = torch.where(cond, -1, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: float = 0.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice score (legacy task-inferring API, reference ``functional/classification/dice.py:67-209``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> dice(preds, target, average='micro')
        tensor(0.2500)
    """
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
        raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

    preds, target = _input_squeeze(preds, target)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _legacy_stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)
