"""Panoptic Quality (port of ``torchmetrics_tpu/functional/detection/panoptic_qualities.py``).

Colours, ``(category, instance)`` pairs, are coded as indices into the batch's
sorted table of distinct colours (``torch.unique`` of one int64 key per pixel,
on the maps' device; only that small table is read on the host, to map
categories to continuous ids). Each sample's segment areas and pairwise intersections are
integer ``bincount``s of those codes, and the matching rules are elementwise
torch ops on the ``(pred segments, target segments)`` matrix, as the JAX
package's ``_pq_update_sample`` computes them. A sample's IoU sums are added in
float64 and rounded once to float32, so they do not depend on the order a
device adds them in.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate the ``things`` / ``stuffs`` category sets."""
    things_parsed = set(things)
    if len(things_parsed) < len(things):
        rank_zero_warn("The provided `things` categories contained duplicates, which have been removed.", UserWarning)
    stuffs_parsed = set(stuffs)
    if len(stuffs_parsed) < len(stuffs):
        rank_zero_warn("The provided `stuffs` categories contained duplicates, which have been removed.", UserWarning)
    if not all(isinstance(v, (int, np.integer)) for v in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(v, (int, np.integer)) for v in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same shape, but got {preds.shape} and {target.shape}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2), "
            f"got {preds.shape}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            "Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance), "
            f"got {preds.shape} instead"
        )


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """An unused (category, instance) color."""
    return 1 + max([0, *list(things), *list(stuffs)]), 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    """things -> [0, len(things)), stuffs -> [len(things), ...) (iteration order)."""
    mapping = {thing_id: idx for idx, thing_id in enumerate(things)}
    mapping.update({stuff_id: idx + len(things) for idx, stuff_id in enumerate(stuffs)})
    return mapping


def _prepocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: Tensor,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> Tensor:
    """Flatten spatial dims to ``(B, N, 2)`` int64, zero stuff instance ids, map unknown categories to void."""
    out = torch.as_tensor(inputs).to(torch.int64)
    out = out.reshape(out.shape[0], -1, 2)
    cats = out[:, :, 0]
    mask_stuffs = torch.isin(cats, torch.tensor(sorted(stuffs), dtype=torch.int64, device=cats.device))
    mask_things = torch.isin(cats, torch.tensor(sorted(things), dtype=torch.int64, device=cats.device))
    inst = torch.where(mask_stuffs, 0, out[:, :, 1])
    known = mask_things | mask_stuffs
    if not allow_unknown_category and not bool(known.all()):
        raise ValueError(f"Unknown categories found: {cats[~known].cpu().numpy()}")
    cats = torch.where(known, cats, void_color[0])
    inst = torch.where(known, inst, void_color[1])
    return torch.stack([cats, inst], dim=-1)


def _segment_sum(values: Tensor, segments: Tensor, num_segments: int) -> Tensor:
    """``jax.ops.segment_sum`` of bool flags (counted in int64) or of float values (added in float64)."""
    dtype = torch.int64 if values.dtype == torch.bool else torch.float64
    return torch.zeros(num_segments, dtype=dtype, device=values.device).index_add_(0, segments, values.to(dtype))


def _pq_update_sample(
    pred_codes: Tensor,
    target_codes: Tensor,
    void_code: int,
    code_cat: Tensor,
    code_cont: Tensor,
    modified_mask: Tensor,
    num_cats: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One sample's ``(iou_sum, tp, fp, fn)`` per continuous category, from its ``(N,)`` colour codes."""
    p_uniq, p_idx = torch.unique(pred_codes, return_inverse=True)
    t_uniq, t_idx = torch.unique(target_codes, return_inverse=True)
    n_p, n_t = p_uniq.numel(), t_uniq.numel()
    p_area = torch.bincount(p_idx, minlength=n_p).to(torch.float32)
    t_area = torch.bincount(t_idx, minlength=n_t).to(torch.float32)
    inter = torch.bincount(p_idx * n_t + t_idx, minlength=n_p * n_t).reshape(n_p, n_t).to(torch.float32)

    p_cat, t_cat = code_cat[p_uniq], code_cat[t_uniq]
    p_real, t_real = p_uniq != void_code, t_uniq != void_code
    # pixels of each segment that fall on the other side's void
    pred_void_area = torch.where(~t_real[None, :], inter, 0.0).sum(dim=1)
    void_target_area = torch.where(~p_real[:, None], inter, 0.0).sum(dim=0)

    union = p_area[:, None] - pred_void_area[:, None] + t_area[None, :] - void_target_area[None, :] - inter
    same_cat = (p_cat[:, None] == t_cat[None, :]) & p_real[:, None] & t_real[None, :]
    iou = torch.where(same_cat & (union > 0), inter / torch.clamp_min(union, 1.0), 0.0)

    t_cont, p_cont = code_cont[t_uniq], code_cont[p_uniq]
    t_modified = torch.where(t_cont >= 0, modified_mask[torch.clamp_min(t_cont, 0)], False)
    p_modified = torch.where(p_cont >= 0, modified_mask[torch.clamp_min(p_cont, 0)], False)
    seg_t, seg_p = torch.clamp_min(t_cont, 0), torch.clamp_min(p_cont, 0)

    # standard rule: iou > 0.5 matches (each segment matches at most once)
    tp_pair = same_cat & (iou > 0.5) & ~t_modified[None, :]
    matched_p, matched_t = tp_pair.any(dim=1), tp_pair.any(dim=0)
    # modified rule (stuffs): accumulate any iou > 0; tp := number of target segments
    mod_pair = same_cat & (iou > 0) & t_modified[None, :]
    iou_sum = _segment_sum(torch.where(tp_pair | mod_pair, iou, 0.0).double().sum(dim=0), seg_t, num_cats)
    tp = _segment_sum(matched_t | (t_real & t_modified), seg_t, num_cats)
    # false negatives / positives: unmatched real segments mostly outside void
    fn = _segment_sum(t_real & ~matched_t & (void_target_area <= 0.5 * t_area) & ~t_modified, seg_t, num_cats)
    fp_seg = p_real & ~matched_p & (pred_void_area <= 0.5 * p_area) & (p_cont >= 0) & ~p_modified
    fp = _segment_sum(fp_seg, seg_p, num_cats)
    return iou_sum.to(torch.float32), tp.to(torch.int32), fp.to(torch.int32), fn.to(torch.int32)


def _panoptic_quality_update(
    flatten_preds: Tensor,
    flatten_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Batch statistics: sum of per-sample ``(iou_sum, tp, fp, fn)``."""
    device = flatten_preds.device
    num_cats = len(cat_id_to_continuous_id)
    modified_mask = torch.zeros(num_cats, dtype=torch.bool, device=device)
    for cat in modified_metric_stuffs or ():
        modified_mask[cat_id_to_continuous_id[cat]] = True

    # dense colour codes: indices into the sorted table of the batch's distinct colours (and the void colour).
    # A colour is one int64 key, category * 2**32 + (instance + 2**31): for ids in the int32 range, which
    # the JAX package casts to, its order is the lexicographic order of np.unique(axis=0)
    void = torch.tensor([void_color], dtype=torch.int64, device=device)
    colors = torch.cat([flatten_preds.reshape(-1, 2), flatten_target.reshape(-1, 2), void])
    uniq_keys, inverse = torch.unique((colors[:, 0] << 32) + (colors[:, 1] + 2**31), return_inverse=True)
    n = flatten_preds.shape[0] * flatten_preds.shape[1]
    pred_codes = inverse[:n].reshape(flatten_preds.shape[:2])
    target_codes = inverse[n : 2 * n].reshape(flatten_target.shape[:2])
    void_code = int(inverse[-1])
    code_cat = uniq_keys >> 32
    code_cont = torch.tensor(
        [cat_id_to_continuous_id.get(int(c), -1) for c in code_cat.tolist()], dtype=torch.int64, device=device
    )

    iou_sum = torch.zeros(num_cats, dtype=torch.float32, device=device)
    tp, fp, fn = (torch.zeros(num_cats, dtype=torch.int32, device=device) for _ in range(3))
    for b in range(pred_codes.shape[0]):
        res = _pq_update_sample(pred_codes[b], target_codes[b], void_code, code_cat, code_cont, modified_mask, num_cats)
        iou_sum += res[0]
        tp += res[1]
        fp += res[2]
        fn += res[3]
    return iou_sum, tp, fp, fn


def _panoptic_quality_compute(
    iou_sum: Tensor, true_positives: Tensor, false_positives: Tensor, false_negatives: Tensor
) -> Tensor:
    """PQ = mean over categories of iou_sum / (tp + fp/2 + fn/2)."""
    denominator = true_positives + 0.5 * false_positives + 0.5 * false_negatives
    pq = torch.where(denominator > 0, iou_sum / torch.clamp_min(denominator, 1e-12), 0.0)
    n_valid = torch.sum(denominator > 0)
    return torch.sum(pq) / torch.clamp_min(n_valid, 1)


def _panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool,
    modified: bool,
) -> Tensor:
    things, stuffs = _parse_categories(things, stuffs)
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things, stuffs)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
    flatten_preds = _prepocess_inputs(things, stuffs, preds, void_color, allow_unknown_preds_category)
    flatten_target = _prepocess_inputs(things, stuffs, target, void_color, True)
    stats = _panoptic_quality_update(
        flatten_preds, flatten_target, cat_id_to_continuous_id, void_color, stuffs if modified else None
    )
    return _panoptic_quality_compute(*stats)


def panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    **kwargs: Any,
) -> Tensor:
    """Compute Panoptic Quality for panoptic segmentations.

    Inputs are ``(B, *spatial, 2)`` int tensors of (category_id, instance_id)
    pairs. Unknown target categories are ignored (mapped to void).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import panoptic_quality
        >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [7, 0], [6, 0], [1, 0]],
        ...                        [[0, 0], [7, 0], [7, 0], [7, 0]]]])
        >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [1, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [7, 0], [7, 0]]]])
        >>> round(float(panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
        0.5463
    """
    return _panoptic_quality(preds, target, things, stuffs, allow_unknown_preds_category, modified=False)


def modified_panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    **kwargs: Any,
) -> Tensor:
    """Compute Modified Panoptic Quality: stuff categories use the relaxed
    (iou > 0, per-target-segment) rule of Porzi et al.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import modified_panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> round(float(modified_panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
        0.7667
    """
    return _panoptic_quality(preds, target, things, stuffs, allow_unknown_preds_category, modified=True)
