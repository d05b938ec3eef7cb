"""Complete IoU functional API (port of ``torchmetrics_tpu/functional/detection/ciou.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.detection._pairwise import pairwise_ciou
from torchmetrics_tpu_torch.functional.detection.iou import _iou_compute, _pairwise_update


def _ciou_update(preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0) -> Tensor:
    return _pairwise_update(pairwise_ciou, preds, target, iou_threshold, replacement_val)


def _ciou_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    return _iou_compute(iou, aggregate)


def complete_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Compute Complete Intersection over Union between two sets of ``xyxy`` boxes."""
    return _ciou_compute(_ciou_update(preds, target, iou_threshold, replacement_val), aggregate)
