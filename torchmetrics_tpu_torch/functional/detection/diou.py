"""Distance IoU functional API (port of ``torchmetrics_tpu/functional/detection/diou.py``)."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.detection._pairwise import pairwise_diou
from torchmetrics_tpu_torch.functional.detection.iou import _iou_compute, _pairwise_update


def _diou_update(preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0) -> Tensor:
    return _pairwise_update(pairwise_diou, preds, target, iou_threshold, replacement_val)


def _diou_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    return _iou_compute(iou, aggregate)


def distance_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Compute Distance Intersection over Union between two sets of ``xyxy`` boxes."""
    return _diou_compute(_diou_update(preds, target, iou_threshold, replacement_val), aggregate)
