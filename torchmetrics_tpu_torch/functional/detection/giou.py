"""Generalized IoU functional API (port of ``torchmetrics_tpu/functional/detection/giou.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.detection._pairwise import pairwise_giou
from torchmetrics_tpu_torch.functional.detection.iou import _iou_compute, _pairwise_update


def _giou_update(preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0) -> Tensor:
    return _pairwise_update(pairwise_giou, preds, target, iou_threshold, replacement_val)


def _giou_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    return _iou_compute(iou, aggregate)


def generalized_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Compute Generalized Intersection over Union between two sets of ``xyxy`` boxes."""
    return _giou_compute(_giou_update(preds, target, iou_threshold, replacement_val), aggregate)
