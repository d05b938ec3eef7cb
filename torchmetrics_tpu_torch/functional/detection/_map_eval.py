"""COCO-style mAP evaluation on the device (port of ``torchmetrics_tpu/functional/detection/_map_eval.py``).

Everything runs as torch ops on padded ``(images, slots)`` arrays, with no
host read until :func:`summarize`:

- **Greedy matching** is a Python loop over score-sorted detection slots
  (:func:`match_detections`) or over per-class ranks
  (:func:`match_detections_ranked`), vectorized over (images, IoU
  thresholds, area ranges); the match state ``(I, T, A, G)`` stays on the
  device. A ground-truth box only competes for detections of its own label,
  so no class axis is needed in the slot loop.
- **Accumulation** (PR curves, 101-point interpolation) sorts all
  detections once by (class, -score), so each class is a contiguous segment,
  and runs segmented cumulative sums, a segmented reverse cumulative max and
  ``searchsorted`` onto the recall points over all rows at once.

pycocotools semantics, as in the JAX package:

- detections processed in score order, stable within equal scores;
- a detection prefers its highest-IoU *non-ignored* available ground truth;
  ties go to the later ground truth (running ``<`` max), it may fall back to
  an ignored one; crowd ground truths can be matched repeatedly;
- crowd IoU uses the detection-area denominator;
- ground truth ignore = crowd or area outside range; unmatched detections
  with area outside range are ignored;
- per-(image, class) detections are capped at ``max(max_detection_thresholds)``
  for matching; smaller thresholds are post-hoc prefix slices;
- ``npig == 0`` classes carry the ``-1`` sentinel and drop out of means.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.detection._pairwise import pairwise_iou_crowd

# COCO area ranges: all / small / medium / large
AREA_RANGES = ((0.0, 1e10), (0.0, 32.0**2), (32.0**2, 96.0**2), (96.0**2, 1e10))
_NO_RANK = 10**9


class MatchResult(NamedTuple):
    """Per-detection-slot matching outcome, all ``(I, D, T, A)`` bool."""

    matched: Tensor
    ignored: Tensor


def _last_argmax(values: Tensor, mask: Tensor) -> Tensor:
    """Index of the *last* occurrence of the masked maximum along the last axis, -1 if the mask is empty.

    Replicates pycocotools' running ``if iou < best: continue`` loop, where a
    later equal IoU replaces the current match; ``torch.argmax`` would take
    the first.
    """
    neg = torch.where(mask, values, -torch.inf)
    best = neg.amax(dim=-1, keepdim=True)
    idx = torch.arange(mask.shape[-1], device=mask.device)
    return torch.where(mask & (neg == best), idx, -1).amax(dim=-1)


def _choose(vals: Tensor, cand: Tensor, ignore: Tensor) -> Tensor:
    """The ground truth a detection takes: the best non-ignored candidate, else the best ignored one, else -1."""
    cand1, cand2 = cand & ~ignore, cand & ignore
    m1, m2 = _last_argmax(vals, cand1), _last_argmax(vals, cand2)
    return torch.where(cand1.any(dim=-1), m1, m2)  # m2 is -1 where cand2 is empty too


def _hit(m_safe: Tensor, matched: Tensor, num_g: int) -> Tensor:
    """One-hot of the chosen ground truth, empty where nothing matched: ``(*m.shape, G)``."""
    return (torch.arange(num_g, device=m_safe.device) == m_safe[..., None]) & matched[..., None]


def match_detections(
    iou: Tensor,  # (I, D, G) with crowd-adjusted values
    det_labels: Tensor,  # (I, D) int, score-sorted per image
    det_participates: Tensor,  # (I, D) bool: valid & class-rank < maxDet
    det_ignore_area: Tensor,  # (I, D, A) bool: det area outside range
    gt_labels: Tensor,  # (I, G) int
    gt_valid: Tensor,  # (I, G) bool
    gt_crowd: Tensor,  # (I, G) bool
    gt_ignore: Tensor,  # (I, A, G) bool: crowd | area outside range
    iou_thresholds: Tensor,  # (T,)
) -> MatchResult:
    """Greedy COCO matching for every (image, threshold, area-range) at once, one step per detection slot."""
    num_i, num_d, num_g = iou.shape
    num_t, num_a = iou_thresholds.shape[0], gt_ignore.shape[1]
    thr = torch.clamp_max(iou_thresholds, 1 - 1e-10)  # pycocotools min(t, 1-1e-10)
    crowd = gt_crowd[:, None, None, :]
    ig = gt_ignore[:, None, :, :]  # (I, 1, A, G)
    ig_full = ig.expand(num_i, num_t, num_a, num_g)

    gt_match = torch.zeros((num_i, num_t, num_a, num_g), dtype=torch.bool, device=iou.device)
    # a slot where no image's detection participates matches nothing and leaves the state as it is:
    # unmatched, ignored iff out of the area range. One host read picks the slots that do, before the loop
    matched_all = torch.zeros((num_i, num_d, num_t, num_a), dtype=torch.bool, device=iou.device)
    ignored_all = det_ignore_area[:, :, None, :].expand(num_i, num_d, num_t, num_a).clone()
    for d in det_participates.any(dim=0).nonzero()[:, 0].tolist():
        iou_d = iou[:, d, :]  # (I, G)
        label_match = (gt_labels == det_labels[:, d, None]) & gt_valid  # (I, G)
        avail = ~gt_match | crowd  # unmatched, or crowd (rematchable)
        meets = iou_d[:, None, :] >= thr[None, :, None]  # (I, T, G)
        cand = label_match[:, None, None, :] & avail & meets[:, :, None, :]  # (I, T, A, G)
        m = _choose(iou_d[:, None, None, :], cand, ig)  # (I, T, A)
        matched = (m >= 0) & det_participates[:, d, None, None]
        m_safe = torch.clamp_min(m, 0)
        # matched to an ignored gt, else an unmatched det outside the area range
        gt_ig_at_m = torch.gather(ig_full, -1, m_safe[..., None])[..., 0]
        matched_all[:, d] = matched
        ignored_all[:, d] = torch.where(matched, gt_ig_at_m, det_ignore_area[:, d, None, :])
        gt_match |= _hit(m_safe, matched, num_g)
    return MatchResult(matched_all, ignored_all)


def match_detections_ranked(
    iou: Tensor,  # (I, D, G)
    det_labels: Tensor,  # (I, D) int, score-sorted per image
    det_participates: Tensor,  # (I, D)
    det_ignore_area: Tensor,  # (I, D, A)
    gt_labels: Tensor,  # (I, G)
    gt_valid: Tensor,  # (I, G)
    gt_crowd: Tensor,  # (I, G)
    gt_ignore: Tensor,  # (I, A, G)
    iou_thresholds: Tensor,  # (T,)
    det_rank: Tensor,  # (I, D) per-class rank (score order within class)
    num_classes: int,
    max_rank: int,
) -> MatchResult:
    """Greedy matching stepped over class rank instead of detection slots.

    Classes never compete for the same ground truth, so all classes'
    rank-``r`` detections match at once: ``max_rank`` steps instead of ``D``.
    Per-class score order (the order pycocotools matches in) is rank order,
    so results equal :func:`match_detections` whenever ``max_rank`` covers
    every participating detection.
    """
    num_i, num_d, num_g = iou.shape
    num_t, num_a = iou_thresholds.shape[0], gt_ignore.shape[1]
    n_cls = num_classes
    dev = iou.device
    thr = torch.clamp_max(iou_thresholds, 1 - 1e-10)

    # slot table: pos[i, c, r] = detection slot of class c's rank-r det (num_d where that cell is empty)
    lbl_c = torch.clamp(det_labels, 0, n_cls - 1).long()
    in_table = det_participates & (det_rank < max_rank) & (det_labels >= 0) & (det_labels < n_cls)
    width = n_cls * max_rank
    flat = torch.where(in_table, lbl_c * max_rank + torch.clamp_max(det_rank, max_rank - 1), width).long()
    d_idx = torch.arange(num_d, device=dev).expand(num_i, num_d)
    pos = torch.full((num_i, width + 1), num_d, dtype=torch.int64, device=dev).scatter_(1, flat, d_idx)
    pos = pos[:, :width].reshape(num_i, n_cls, max_rank)

    label_match = (gt_labels[:, None, :] == torch.arange(n_cls, device=dev)[None, :, None]) & gt_valid[:, None, :]
    ig5 = gt_ignore[:, None, None, :, :]  # (I, 1, 1, A, G)
    ig5_full = ig5.expand(num_i, n_cls, num_t, num_a, num_g)
    crowd = gt_crowd[:, None, None, :]
    # slot num_d holds neutral rows so the gathers stay in bounds
    iou_pad = torch.cat([iou, torch.zeros((num_i, 1, num_g), dtype=iou.dtype, device=dev)], dim=1)
    part_pad = torch.cat([det_participates, torch.zeros((num_i, 1), dtype=torch.bool, device=dev)], dim=1)

    gt_match = torch.zeros((num_i, num_t, num_a, num_g), dtype=torch.bool, device=dev)
    matched_r = torch.empty((max_rank, num_i, n_cls, num_t, num_a), dtype=torch.bool, device=dev)
    ignored_r = torch.empty_like(matched_r)
    for r in range(max_rank):
        slots = pos[:, :, r]  # (I, C)
        iou_r = torch.gather(iou_pad, 1, slots[..., None].expand(num_i, n_cls, num_g))  # (I, C, G)
        part_r = torch.gather(part_pad, 1, slots)  # (I, C)
        avail = ~gt_match | crowd  # (I, T, A, G)
        meets = iou_r[:, :, None, :] >= thr[None, None, :, None]  # (I, C, T, G)
        cand = label_match[:, :, None, None, :] & avail[:, None] & meets[:, :, :, None, :]  # (I, C, T, A, G)
        m = _choose(iou_r[:, :, None, None, :], cand, ig5)  # (I, C, T, A)
        matched = (m >= 0) & part_r[:, :, None, None]
        m_safe = torch.clamp_min(m, 0)
        gt_ig_at_m = torch.gather(ig5_full, -1, m_safe[..., None])[..., 0]
        matched_r[r] = matched
        ignored_r[r] = matched & gt_ig_at_m
        # classes claim disjoint gts, so the per-class hits OR together exactly
        gt_match |= _hit(m_safe, matched, num_g).any(dim=1)

    # (R, I, C, T, A) -> per original detection slot via a (rank, class) gather
    rank_c = torch.clamp_max(det_rank, max_rank - 1).long()
    i_idx = torch.arange(num_i, device=dev)[:, None]
    sel = in_table[..., None, None]
    matched_out = matched_r[rank_c, i_idx, lbl_c] & sel  # (I, D, T, A)
    ignored_out = ignored_r[rank_c, i_idx, lbl_c]
    # unmatched (or untabled) detections are ignored iff their area is out of range, as in the slot loop
    area_ign = det_ignore_area[:, :, None, :].expand_as(matched_out)
    return MatchResult(matched_out, torch.where(matched_out, ignored_out & sel, area_ign))


def _flip_cum(op, x: Tensor) -> Tensor:
    """Right-to-left cumulative ``op`` (``torch.cummax``/``cummin``) along the last axis."""
    return torch.flip(op(torch.flip(x, [-1]), dim=-1).values, [-1])


def _packed(high: Tensor, value: Tensor) -> Tensor:
    """``high << 32 | bits(value)`` in int64, for non-negative float32 ``value``: orders by ``high``, then by ``value``."""
    return (high.long() << 32) | value.view(torch.int32).long()


def _unpacked(key: Tensor) -> Tensor:
    """The float32 value of a :func:`_packed` key."""
    return (key & 0xFFFFFFFF).int().view(torch.float32)


def accumulate(
    matched: Tensor,  # (I, D, T, A) bool
    ignored: Tensor,  # (I, D, T, A) bool
    det_scores: Tensor,  # (I, D) score-sorted per image
    det_labels: Tensor,  # (I, D)
    det_valid: Tensor,  # (I, D)
    det_class_rank: Tensor,  # (I, D) rank of det within its class per image
    gt_labels: Tensor,  # (I, G)
    gt_valid: Tensor,  # (I, G)
    gt_ignore: Tensor,  # (I, A, G)
    class_ids: Tensor,  # (C,) evaluated class ids (pad with -1)
    rec_thresholds: Tensor,  # (R,)
    max_dets: Sequence[int],  # ascending
):
    """PR-curve accumulation: pycocotools ``COCOeval.accumulate`` on the device.

    One global stable (label, -score) sort makes every class's detections a
    contiguous, score-descending segment of the flat ``(I * D, T, A)`` rows.
    The curves are segmented scans over all rows at once, so the work is
    O(detections), whatever the classes' sizes (the JAX package pads every
    class to the largest one's count):

    - true and false positive counts are integer cumulative sums minus the
      count before the segment;
    - the precision envelope is a reverse cumulative max of int64 keys
      ``(segments after, bits(precision))``, which no later segment can raise;
    - the recall points are ``searchsorted`` into keys ``(segment, bits(recall))``,
      non-decreasing over all rows, and a hit outside the class's segment is
      a miss.

    Every value is the JAX package's to the bit: counts are exact and each
    ratio is the same float32 division. Curve rows include ignored detections
    as flat points, exactly like pycocotools' accumulate.

    Returns ``precision (T, R, C, A, M)``, ``recall (T, C, A, M)`` and
    ``scores (T, R, C, A, M)`` with ``-1`` sentinels, matching the
    reference's ``eval['precision'|'recall'|'scores']``.
    """
    num_i, num_d = det_scores.shape
    num_t, num_a = matched.shape[2], matched.shape[3]
    dev = det_scores.device
    n_flat, n_ta = num_i * num_d, num_t * num_a
    max_dets = tuple(int(m) for m in max_dets)

    scores_f = det_scores.reshape(n_flat)
    rank_f = det_class_rank.reshape(n_flat)
    include = det_valid.reshape(n_flat) & (rank_f < max_dets[-1])
    # two-pass stable sort: score-descending, then label-major; within a segment rows are
    # score-descending in image-major tie order, as pycocotools' per-class concatenate + mergesort
    order1 = torch.argsort(torch.where(include, -scores_f, torch.inf), stable=True)
    lab1 = torch.where(include, det_labels.reshape(n_flat).long(), 2**30)[order1]
    order2 = torch.argsort(lab1, stable=True)
    perm = order1[order2]
    labels_sorted = lab1[order2]
    scores_g = scores_f[perm]
    rank_g = rank_f[perm]
    # (T * A, rows): the scans run along the last, contiguous axis
    matched_g = matched.reshape(n_flat, n_ta)[perm].T.contiguous()
    ignored_g = ignored.reshape(n_flat, n_ta)[perm].T.contiguous()

    # segments: runs of one label; each row's segment id, first row and end
    idx = torch.arange(n_flat, device=dev)
    starts_run = torch.ones(n_flat, dtype=torch.bool, device=dev)
    starts_run[1:] = labels_sorted[1:] != labels_sorted[:-1]
    run = torch.cumsum(starts_run.long(), 0) - 1
    run_start = torch.cummax(torch.where(starts_run, idx, 0), 0).values
    ends_run = torch.ones_like(starts_run)
    ends_run[:-1] = starts_run[1:]
    run_end = _flip_cum(torch.cummin, torch.where(ends_run, idx + 1, n_flat))

    cids = class_ids.long()
    starts = torch.searchsorted(labels_sorted, cids, side="left")
    ends = torch.searchsorted(labels_sorted, cids, side="right")
    nonempty = starts < ends
    # non-ignored ground truths per (class, area range), and each row's count for its own label
    in_class = (gt_labels.long()[None] == cids[:, None, None]) & gt_valid[None]  # (C, I, G)
    npig = torch.stack([(in_class & ~gt_ignore[None, :, a, :]).sum(dim=(1, 2)) for a in range(num_a)], dim=1)
    sorted_cids, cid_order = torch.sort(cids)
    pos = torch.clamp_max(torch.searchsorted(sorted_cids, labels_sorted), cids.shape[0] - 1)
    row_class = torch.where(sorted_cids[pos] == labels_sorted, cid_order[pos], -1)
    npig_row = torch.where(row_class[None, :] >= 0, npig[torch.clamp_min(row_class, 0)].T.repeat(num_t, 1), 1)
    npig_row = torch.clamp_min(npig_row.to(torch.float32), 1.0)  # (T * A, rows), A fastest as in (T, A)

    # the recall points of each class as keys into its own segment: (T * A, C * R)
    r_thr = rec_thresholds.to(torch.float32)
    num_r = r_thr.shape[0]
    run_of_class = run[torch.clamp_max(starts, n_flat - 1)]
    queries = _packed(run_of_class[:, None].expand(-1, num_r), r_thr[None, :].expand(cids.shape[0], -1))
    queries = queries.reshape(1, -1).expand(n_ta, -1).contiguous()
    has_gt = (npig > 0)[None, :, :, None].expand(num_t, -1, -1, num_r)  # (T, C, A, R)
    last = torch.clamp_min(ends - 1, 0)

    qs, ss, rs = [], [], []
    for m in max_dets:
        sel = rank_g < m  # (rows,)
        use = sel[None, :] & ~ignored_g
        tp_c = torch.cumsum((use & matched_g).int(), dim=-1)
        fp_c = torch.cumsum((use & ~matched_g).int(), dim=-1)
        # counts from the start of each row's segment
        tp = (tp_c - (tp_c - (use & matched_g).int()).gather(1, run_start[None, :].expand(n_ta, -1))).to(torch.float32)
        fp = (fp_c - (fp_c - (use & ~matched_g).int()).gather(1, run_start[None, :].expand(n_ta, -1))).to(torch.float32)
        rc = tp / npig_row
        pr = tp / torch.clamp_min(tp + fp, 1e-12)
        pr_env = _unpacked(_flip_cum(torch.cummax, _packed((run[-1] - run)[None, :].expand(n_ta, -1), pr)))
        # a sample may land on an excluded row; the pycocotools sample is the NEXT selected row
        next_sel = _flip_cum(torch.cummin, torch.where(sel, idx, run_end))
        score_at_next = torch.where(next_sel < run_end, scores_g[torch.clamp_max(next_sel, n_flat - 1)], 0.0)

        inds = torch.searchsorted(_packed(run[None, :].expand(n_ta, -1), rc), queries, side="left")
        inds = inds.reshape(num_t, num_a, cids.shape[0], num_r).permute(0, 2, 1, 3)  # (T, C, A, R)
        ok = nonempty[None, :, None, None] & (inds < ends[None, :, None, None])
        inds_c = torch.clamp_max(inds, n_flat - 1)
        pr_tca = pr_env.reshape(num_t, num_a, n_flat)
        q = torch.where(ok, torch.gather(pr_tca[:, None].expand(-1, cids.shape[0], -1, -1), 3, inds_c), 0.0)
        s = torch.where(ok, score_at_next[inds_c], 0.0)
        qs.append(torch.where(has_gt, q, -1.0).permute(0, 3, 1, 2))  # (T, R, C, A)
        ss.append(torch.where(has_gt, s, -1.0).permute(0, 3, 1, 2))
        total = torch.where(nonempty[None, :, None], tp.reshape(num_t, num_a, n_flat)[:, :, last].permute(0, 2, 1), 0.0)
        rs.append(torch.where(npig[None] > 0, total / torch.clamp_min(npig.to(torch.float32), 1.0)[None], -1.0))
    return torch.stack(qs, dim=-1), torch.stack(rs, dim=-1), torch.stack(ss, dim=-1)


def compute_class_ranks(det_labels: Tensor, det_valid: Tensor, num_classes: int) -> Tensor:
    """Per-image rank of each detection within its own class, for score-sorted input; ``10**9`` where invalid.

    A stable sort by label keeps score order inside each class, and a row's
    rank is its position minus the first position of its label.
    """
    key = torch.where(det_valid, det_labels.long(), num_classes)
    order = torch.argsort(key, dim=1, stable=True)
    sorted_key = torch.gather(key, 1, order)
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank_sorted = torch.arange(key.shape[1], device=key.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    return torch.where(det_valid, rank, _NO_RANK)


def evaluate_map(
    det_boxes: Tensor,  # (I, D, 4) xyxy
    det_scores: Tensor,  # (I, D)
    det_labels: Tensor,  # (I, D) int
    det_valid: Tensor,  # (I, D) bool
    det_area: Tensor,  # (I, D)
    gt_boxes: Tensor,  # (I, G, 4) xyxy
    gt_labels: Tensor,  # (I, G)
    gt_valid: Tensor,  # (I, G)
    gt_crowd: Tensor,  # (I, G)
    gt_area: Tensor,  # (I, G)
    class_ids: Tensor,  # (C,) pad with -1
    iou_thresholds: Tensor,  # (T,)
    rec_thresholds: Tensor,  # (R,)
    max_dets: Sequence[int],
    num_classes: int,
    area_ranges: Optional[Tensor] = None,  # (A, 2)
    iou_override: Optional[Tensor] = None,  # (I, D, G) precomputed (segm mode)
    max_class_rank: int = 0,  # cap on per-(image, class) det count; > 0 enables rank-stepped matching
):
    """Full COCO evaluation on the device: sort, IoU, match, accumulate.

    The JAX package's ``max_class_dets`` (a static per-class width for its
    accumulation) has no counterpart: the segmented accumulation needs none.
    """
    dev = det_scores.device
    if area_ranges is None:
        area_ranges = torch.tensor(AREA_RANGES, dtype=torch.float32, device=dev)

    # per-image stable sort by descending score, padding last
    order = torch.argsort(torch.where(det_valid, -det_scores, torch.inf), dim=1, stable=True)
    det_boxes = torch.gather(det_boxes, 1, order[..., None].expand(*order.shape, 4))
    det_scores, det_labels, det_valid, det_area = (
        torch.gather(x, 1, order) for x in (det_scores, det_labels, det_valid, det_area)
    )
    rank = compute_class_ranks(det_labels, det_valid, num_classes)

    gt_crowd = gt_crowd.bool()
    if iou_override is not None:
        iou = torch.gather(iou_override, 1, order[..., None].expand(*order.shape, iou_override.shape[2]))
    else:
        iou = pairwise_iou_crowd(det_boxes, gt_boxes, gt_crowd)
    iou = torch.where(det_valid[:, :, None] & gt_valid[:, None, :], iou, 0.0)

    lo = area_ranges[:, 0][None, None, :]
    hi = area_ranges[:, 1][None, None, :]
    det_ignore_area = (det_area[..., None] < lo) | (det_area[..., None] > hi)  # (I, D, A)
    gt_out = (gt_area[..., None] < lo) | (gt_area[..., None] > hi)  # (I, G, A)
    gt_ignore = ((gt_crowd[..., None] | gt_out) & gt_valid[..., None]).movedim(2, 1)  # (I, A, G)

    participates = det_valid & (rank < int(max_dets[-1]))
    args = (iou, det_labels, participates, det_ignore_area, gt_labels, gt_valid, gt_crowd, gt_ignore, iou_thresholds)
    # rank-stepped matching trades sequential depth (D -> max_rank) for a per-step class axis; it only
    # wins when the (C x max_rank) table is no wider than the slot axis it replaces
    if 0 < max_class_rank and num_classes * max_class_rank <= det_labels.shape[1]:
        res = match_detections_ranked(*args, rank, num_classes, int(max_class_rank))
    else:
        res = match_detections(*args)
    return accumulate(
        res.matched, res.ignored, det_scores, det_labels, det_valid, rank, gt_labels, gt_valid, gt_ignore,
        class_ids, rec_thresholds, max_dets,
    )


def summarize(
    precision: np.ndarray,  # (T, R, C, A, M)
    recall: np.ndarray,  # (T, C, A, M)
    iou_thresholds: Sequence[float],
    max_dets: Sequence[int],
) -> dict:
    """pycocotools ``summarize`` on the accumulated arrays, on the host (they are small)."""
    iou_thresholds = list(iou_thresholds)

    def _summ_ap(t_idx=None, a_idx=0, m_idx=None):
        m_idx = len(max_dets) - 1 if m_idx is None else m_idx
        s = precision[:, :, :, a_idx, m_idx] if t_idx is None else precision[t_idx : t_idx + 1, :, :, a_idx, m_idx]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def _summ_ar(a_idx=0, m_idx=None):
        m_idx = len(max_dets) - 1 if m_idx is None else m_idx
        s = recall[:, :, a_idx, m_idx]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def _t(v):
        return iou_thresholds.index(v) if v in iou_thresholds else None

    out = {
        "map": _summ_ap(),
        "map_50": _summ_ap(t_idx=_t(0.5)) if _t(0.5) is not None else -1.0,
        "map_75": _summ_ap(t_idx=_t(0.75)) if _t(0.75) is not None else -1.0,
        "map_small": _summ_ap(a_idx=1),
        "map_medium": _summ_ap(a_idx=2),
        "map_large": _summ_ap(a_idx=3),
        "mar_small": _summ_ar(a_idx=1),
        "mar_medium": _summ_ar(a_idx=2),
        "mar_large": _summ_ar(a_idx=3),
    }
    for i, m in enumerate(max_dets):
        out[f"mar_{m}"] = _summ_ar(m_idx=i)
    return out
