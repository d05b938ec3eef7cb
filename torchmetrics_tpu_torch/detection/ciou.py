"""Modular Complete IoU metric (port of ``torchmetrics_tpu/detection/ciou.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from torchmetrics_tpu_torch.detection.iou import IntersectionOverUnion
from torchmetrics_tpu_torch.functional.detection.ciou import _ciou_compute, _ciou_update


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """Computes Complete Intersection Over Union (CIoU)."""

    _iou_type: str = "ciou"
    _invalid_val: float = -1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(box_format, iou_threshold, class_metrics, respect_labels, **kwargs)

    @staticmethod
    def _iou_update_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _ciou_update(*args, **kwargs)

    @staticmethod
    def _iou_compute_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _ciou_compute(*args, **kwargs)
