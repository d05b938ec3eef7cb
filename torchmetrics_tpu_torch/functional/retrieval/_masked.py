"""Mask-aware retrieval kernels on a padded batch of queries (port of ``torchmetrics_tpu/functional/retrieval/_masked.py``).

The JAX package writes each kernel on one ``(L,)`` query and maps it over
the queries with ``jax.vmap``; here each takes ``(num_q, L)`` arrays and
works along the last axis. ``preds`` padding is ``-inf`` (it sorts last),
``target`` padding 0, and ``mask`` is True on the valid entries. ``top_k`` is
an int or None (all). Every sort is a stable descending ``torch.sort``, which
keeps tied scores in their input order as the JAX package's
``argsort(-p, stable=True)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

NEG_INF = float("-inf")


def _sorted_by_preds(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Scores, targets and mask in stable descending order of the scores, padding last."""
    p = torch.where(mask, preds, NEG_INF)
    p_sorted, order = torch.sort(p, dim=-1, descending=True, stable=True)
    return p_sorted, target.gather(-1, order), mask.gather(-1, order)


def _positions(x: Tensor, dtype: torch.dtype = torch.int64) -> Tensor:
    """1-based positions along the last axis."""
    return torch.arange(1, x.shape[-1] + 1, device=x.device, dtype=dtype)


def _topk_keep(mask_sorted: Tensor, top_k: Optional[int]) -> Tensor:
    """Sorted positions that count: valid and within ``top_k``."""
    if top_k is None:
        return mask_sorted
    return mask_sorted & (_positions(mask_sorted) <= top_k)


def average_precision_masked(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    _, t, m = _sorted_by_preds(preds, target, mask)
    rel = (t > 0) & _topk_keep(m, top_k)
    cum_rel = torch.cumsum(rel.to(torch.float32), dim=-1)
    n_rel = rel.sum(-1)
    ap = torch.where(rel, cum_rel / _positions(t, torch.float32), 0.0).sum(-1)
    return torch.where(n_rel > 0, ap / torch.clamp(n_rel, min=1), 0.0)


def reciprocal_rank_masked(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    _, t, m = _sorted_by_preds(preds, target, mask)
    rel = (t > 0) & _topk_keep(m, top_k)
    first = torch.where(rel, _positions(t, torch.float32), float("inf")).amin(-1)
    return torch.where(torch.isfinite(first), 1.0 / first, 0.0)


def precision_masked(
    preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> Tensor:
    n_valid = mask.sum(-1)
    k = n_valid if top_k is None else torch.full_like(n_valid, top_k)
    _, t, m = _sorted_by_preds(preds, target, mask)
    if adaptive_k:
        k = torch.minimum(k, n_valid)
        keep = m & (_positions(t) <= k[..., None])
    else:
        keep = _topk_keep(m, top_k)
    rel = ((t > 0) & keep).to(torch.float32).sum(-1)
    return rel / k.to(torch.float32)


def recall_masked(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    total_rel = ((target > 0) & mask).to(torch.float32).sum(-1)
    _, t, m = _sorted_by_preds(preds, target, mask)
    rel = ((t > 0) & _topk_keep(m, top_k)).to(torch.float32).sum(-1)
    return torch.where(total_rel > 0, rel / torch.clamp(total_rel, min=1.0), 0.0)


def fall_out_masked(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    total_irrel = ((target == 0) & mask).to(torch.float32).sum(-1)
    _, t, m = _sorted_by_preds(preds, target, mask)
    irrel = ((t == 0) & _topk_keep(m, top_k)).to(torch.float32).sum(-1)
    return torch.where(total_irrel > 0, irrel / torch.clamp(total_irrel, min=1.0), 0.0)


def hit_rate_masked(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    _, t, m = _sorted_by_preds(preds, target, mask)
    return ((t > 0) & _topk_keep(m, top_k)).any(-1).to(torch.float32)


def r_precision_masked(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    total_rel = ((target > 0) & mask).sum(-1)
    _, t, m = _sorted_by_preds(preds, target, mask)
    keep = m & (_positions(t) <= total_rel[..., None])
    rel = ((t > 0) & keep).to(torch.float32).sum(-1)
    return torch.where(total_rel > 0, rel / torch.clamp(total_rel, min=1).to(torch.float32), 0.0)


def _descending_rank(preds: Tensor, mask: Tensor) -> Tensor:
    """0-based position of each entry in the stable descending order (the JAX package's double argsort)."""
    _, order = torch.sort(torch.where(mask, preds, NEG_INF), dim=-1, descending=True, stable=True)
    positions = torch.arange(preds.shape[-1], device=preds.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, positions)


def _run_bounds(sorted_values: Tensor) -> Tuple[Tensor, Tensor]:
    """0-based start and length of the run of equal values each sorted position lies in."""
    length = sorted_values.shape[-1]
    pos = torch.arange(length, device=sorted_values.device).expand_as(sorted_values)
    differs = sorted_values[..., 1:] != sorted_values[..., :-1]
    edge = torch.ones_like(differs[..., :1])
    starts = torch.where(torch.cat([edge, differs], -1), pos, 0).cummax(-1).values
    ends = torch.where(torch.cat([differs, edge], -1), pos, length).flip(-1).cummin(-1).values.flip(-1)
    return starts, ends - starts + 1


def auroc_masked(
    preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None, max_fpr: Optional[float] = None
) -> Tensor:
    """Rank-statistic AUROC (Mann-Whitney U) over the valid entries; ties get their average rank.

    With ``top_k`` only the k highest-scoring valid entries count. With
    ``max_fpr`` the McClish-corrected partial AUC is computed from the ROC
    staircase instead. The average ranks come from one ascending sort (the
    padding as NaN sorts after every valid score) and the runs of equal
    scores in it: the count of smaller valid scores plus half that of the
    equal ones and one, as the JAX package's O(L²) comparison counts them.
    They are integers or half-integers, so their float32 sum is exact, in
    any order, up to 2**24.
    """
    if top_k is not None:
        mask = mask & (_descending_rank(preds, mask) < top_k)
    if max_fpr is not None and max_fpr != 1:
        return _partial_auroc_masked(preds, target, mask, max_fpr)
    keys, order = torch.sort(torch.where(mask, preds, float("nan")), dim=-1, stable=True)
    starts, counts = _run_bounds(keys)
    ranks = starts.to(torch.float32) + (counts.to(torch.float32) + 1.0) / 2.0
    rel = ((target > 0) & mask).gather(-1, order)
    irrel = (target == 0) & mask
    n_pos = rel.to(torch.float32).sum(-1)
    n_neg = irrel.to(torch.float32).sum(-1)
    rank_sum = torch.where(rel, ranks, 0.0).sum(-1)
    auc = (rank_sum - n_pos * (n_pos + 1) / 2) / torch.clamp(n_pos * n_neg, min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, 0.0)


def _safe_div(a: Tensor, b: Tensor) -> Tensor:
    return a / torch.clamp(b, min=1.0)


def _shift_right(x: Tensor) -> Tensor:
    """``x`` moved one place along the last axis, a 0 in front."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], -1)


def _partial_auroc_masked(preds: Tensor, target: Tensor, mask: Tensor, max_fpr: float) -> Tensor:
    """McClish-corrected partial AUC over the masked ROC staircase (JAX ``_masked.py:130``).

    Sort by score, keep only the last point of each tie run, re-sort those
    points stably by false positive rate (the others, set to -1, lead), clip
    the curve at ``max_fpr`` by linear interpolation, take the trapezoids and
    rescale as ``0.5 * (1 + (area - min) / (max - min))``.
    """
    p_s, t_s, w_s = _sorted_by_preds(preds, (target > 0) & mask, mask)
    w_s = w_s.to(torch.float32)
    t_s = t_s.to(torch.float32) * w_s
    tps = torch.cumsum(t_s, -1)
    fps = torch.cumsum(w_s - t_s, -1)
    n_pos, n_neg = tps[..., -1:], fps[..., -1:]
    is_boundary = torch.cat([p_s[..., :-1] != p_s[..., 1:], torch.ones_like(p_s[..., :1], dtype=torch.bool)], -1)
    tpr = torch.where(is_boundary, _safe_div(tps, n_pos), 0.0)
    fpr = torch.where(is_boundary, _safe_div(fps, n_neg), 0.0)
    _, reorder = torch.sort(torch.where(is_boundary, fps, -1.0), dim=-1, stable=True)
    tpr, fpr = tpr.gather(-1, reorder), fpr.gather(-1, reorder)
    mfpr = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    prev_fpr, prev_tpr = _shift_right(fpr), _shift_right(tpr)
    seg = torch.where(fpr > prev_fpr, (tpr - prev_tpr) / torch.clamp(fpr - prev_fpr, min=1e-12), 0.0)
    tpr_at = prev_tpr + seg * (mfpr - prev_fpr)
    tpr_c = torch.where(fpr <= mfpr, tpr, torch.where(prev_fpr < mfpr, tpr_at, 0.0))
    fpr_c = torch.minimum(fpr, mfpr)
    prev_fc, prev_tc = _shift_right(fpr_c), _shift_right(tpr_c)
    area = torch.where(fpr_c > prev_fc, (fpr_c - prev_fc) * (tpr_c + prev_tc) / 2.0, 0.0).sum(-1)
    min_area = 0.5 * mfpr * mfpr
    part = 0.5 * (1.0 + (area - min_area) / torch.clamp(mfpr - min_area, min=1e-12))
    return torch.where((n_pos[..., 0] > 0) & (n_neg[..., 0] > 0), part, 0.0)


def ndcg_masked(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """nDCG with a log2 discount; tied scores share their run's mean discount (JAX ``_masked.py:179``).

    Every run of equal sorted scores contributes its mean gain times the sum
    of its discounts: here each entry takes its run's mean discount, from
    the runs of equal consecutive sorted scores (the padding, ``-inf``, is
    one trailing run with no gain). The ideal DCG sorts the targets and
    ignores ties.
    """
    length = preds.shape[-1]
    pos = torch.arange(length, device=preds.device, dtype=torch.float32)
    discount = 1.0 / torch.log2(pos + 2.0)
    if top_k is not None:
        discount = torch.where(pos < top_k, discount, 0.0)

    p_sorted, t, m = _sorted_by_preds(preds, target, mask)
    new_run = torch.cat([torch.ones_like(p_sorted[..., :1], dtype=torch.int64),
                         (p_sorted[..., 1:] != p_sorted[..., :-1]).to(torch.int64)], -1)
    gid = torch.cumsum(new_run, -1) - 1
    disc = discount.expand_as(p_sorted)
    seg_disc = torch.zeros_like(disc).scatter_add_(-1, gid, disc)
    seg_cnt = torch.zeros_like(disc).scatter_add_(-1, gid, torch.ones_like(disc))
    avg_disc = seg_disc.gather(-1, gid) / torch.clamp(seg_cnt.gather(-1, gid), min=1.0)
    gain = (torch.where(m, t.to(torch.float32), 0.0) * avg_disc).sum(-1)

    ideal = torch.sort(torch.where(mask, target.to(torch.float32), NEG_INF), dim=-1, descending=True).values
    ideal = torch.where(torch.isfinite(ideal), ideal, 0.0)
    ideal_gain = (ideal * discount).sum(-1)
    return torch.where(ideal_gain > 0, gain / torch.clamp(ideal_gain, min=1e-12), 0.0)
