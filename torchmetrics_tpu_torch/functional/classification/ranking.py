"""Multilabel ranking metrics (port of ``torchmetrics_tpu/functional/classification/ranking.py``).

Coverage error, label-ranking average precision and label-ranking loss. Ranks
come from pairwise comparisons of the scores in each row, an ``(N, L, L)``
temporary, with tied scores taking their average rank: the formula fixes the
tie semantics, so it is kept rather than replaced by a sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]` to be {num_labels}")
    if not torch.is_floating_point(preds):
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")


def _multilabel_ranking_format(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    preds = torch.movedim(preds.to(torch.float32), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    if ignore_index is not None:
        # drop the rows that hold an ignored entry
        keep = ~torch.any(target == ignore_index, dim=1)
        preds, target = preds[keep], target[keep]
    return preds, target


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    # per sample: the lowest-ranked relevant label's 1-indexed position in descending score order,
    # i.e. how far down the list one must go to cover every relevant label
    offset = torch.where(target == 1, 0.0, 1e30)
    min_relevant_score = torch.min(preds + offset, dim=1, keepdim=True).values
    has_relevant = torch.any(target == 1, dim=1)
    coverage = torch.sum(preds >= min_relevant_score, dim=1).to(torch.float32)
    coverage = torch.where(has_relevant, coverage, 0.0)
    return torch.sum(coverage), preds.shape[0]


def multilabel_coverage_error(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Coverage error: average depth needed to cover all relevant labels.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multilabel_coverage_error
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> multilabel_coverage_error(preds, target, num_labels=3)
        tensor(1.3333)
    """
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    coverage, total = _multilabel_coverage_error_update(preds, target)
    return coverage / total


def _rank_with_ties(scores: Tensor) -> Tensor:
    """Descending rank per row (1-indexed), tied scores taking their average rank."""
    gt = (scores[:, None, :] > scores[:, :, None]).sum(dim=-1).to(torch.float32)
    eq = (scores[:, None, :] == scores[:, :, None]).sum(dim=-1).to(torch.float32)
    return gt + (eq + 1.0) / 2.0


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    n, num_labels = preds.shape
    rank_all = _rank_with_ties(preds)  # rank among all labels (descending)
    # rank among the relevant labels only: the relevant labels scored at or above this one
    relevant = target == 1
    rel_scores = torch.where(relevant, preds, -torch.inf)
    gt_rel = ((rel_scores[:, None, :] > preds[:, :, None]) & relevant[:, None, :]).sum(dim=-1).to(torch.float32)
    eq_rel = ((rel_scores[:, None, :] == preds[:, :, None]) & relevant[:, None, :]).sum(dim=-1).to(torch.float32)
    rank_rel = gt_rel + (eq_rel + 1.0) / 2.0

    ratio = torch.where(relevant, rank_rel / rank_all, 0.0)
    n_relevant = relevant.sum(dim=1)
    per_sample = torch.where(
        (n_relevant > 0) & (n_relevant < num_labels),
        torch.sum(ratio, dim=1) / torch.clamp(n_relevant, min=1),
        1.0,
    )
    return torch.sum(per_sample), n


def multilabel_ranking_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label-ranking average precision."""
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    score, total = _multilabel_ranking_average_precision_update(preds, target)
    return score / total


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    n, num_labels = preds.shape
    relevant = target == 1
    n_relevant = relevant.sum(dim=1)
    n_irrelevant = num_labels - n_relevant
    # mis-ordered (relevant, irrelevant) pairs: score_rel <= score_irr
    rel_s = torch.where(relevant, preds, torch.nan)
    irr_s = torch.where(~relevant, preds, torch.nan)
    pairs = (rel_s[:, :, None] <= irr_s[:, None, :]).to(torch.float32)
    pairs = torch.where(torch.isnan(rel_s)[:, :, None] | torch.isnan(irr_s)[:, None, :], 0.0, pairs)
    miss = pairs.sum(dim=(1, 2))
    denom = (n_relevant * n_irrelevant).to(torch.float32)
    loss = torch.where(denom > 0, miss / torch.clamp(denom, min=1.0), 0.0)
    return torch.sum(loss), n


def multilabel_ranking_loss(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label-ranking loss: fraction of mis-ordered label pairs."""
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_ranking_format(preds, target, num_labels, ignore_index)
    loss, total = _multilabel_ranking_loss_update(preds, target)
    return loss / total
