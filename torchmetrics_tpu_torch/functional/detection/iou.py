"""IoU functional API (port of ``torchmetrics_tpu/functional/detection/iou.py``).

The pairwise matrix is ``_pairwise.pairwise_iou``, elementwise torch ops on
the boxes' device. ``_iou_compute`` and the threshold step are shared by the
GIoU, DIoU and CIoU modules.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.detection._pairwise import pairwise_iou


def _pairwise_update(
    pairwise: Callable[[Tensor, Tensor], Tensor],
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float],
    replacement_val: float = 0,
) -> Tensor:
    """``pairwise`` of the float32 boxes, with values under ``iou_threshold`` replaced."""
    preds = torch.as_tensor(preds, dtype=torch.float32)
    iou = pairwise(preds, torch.as_tensor(target, dtype=torch.float32, device=preds.device))
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.full_like(iou, replacement_val), iou)
    return iou


def _iou_update(preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0) -> Tensor:
    return _pairwise_update(pairwise_iou, preds, target, iou_threshold, replacement_val)


def _iou_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    if not aggregate:
        return iou
    return torch.diagonal(iou).mean() if iou.numel() > 0 else torch.tensor(0.0, device=iou.device)


def intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    """Compute Intersection over Union between two sets of ``xyxy`` boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79],
        ...                       [328.94, 97.05, 342.49, 122.98],
        ...                       [356.62, 95.47, 372.33, 147.55]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00],
        ...                        [330.00, 100.00, 350.00, 125.00],
        ...                        [350.00, 100.00, 375.00, 150.00]])
        >>> round(float(intersection_over_union(preds, target)), 4)
        0.5879
    """
    return _iou_compute(_iou_update(preds, target, iou_threshold, replacement_val), aggregate)
