"""Modular IoU metric (port of ``torchmetrics_tpu/detection/iou.py``).

Per-image ``(N, M)`` similarity matrices are computed on the metric's device
and appended to a list state (``dist_reduce_fx=None``); pairs whose labels
differ, or under the threshold, carry ``_invalid_val``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.detection.helpers import _as_tensor, _fix_empty_tensors, _input_validator
from torchmetrics_tpu_torch.functional.detection._pairwise import box_convert
from torchmetrics_tpu_torch.functional.detection.iou import _iou_compute, _iou_update
from torchmetrics_tpu_torch.metric import Metric


class IntersectionOverUnion(Metric):
    """Computes Intersection Over Union (IoU) over per-image box dicts.

    Inputs follow the reference protocol: lists of per-image dicts with
    ``boxes`` ``(N, 4)`` and ``labels`` ``(N,)`` (plus ``scores`` for preds,
    unused here). Output is ``{"iou": scalar}`` plus ``iou/cl_{c}`` entries
    when ``class_metrics=True``.
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    _iou_type: str = "iou"
    _invalid_val: float = -1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("iou_matrix", default=[], dist_reduce_fx=None)

    @staticmethod
    def _iou_update_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _iou_update(*args, **kwargs)

    @staticmethod
    def _iou_compute_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _iou_compute(*args, **kwargs)

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        """Update state with per-image prediction and target box dicts."""
        _input_validator(preds, target, ignore_score=True)

        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            gt_labels = _as_tensor(t["labels"], torch.int64, self.device)
            self.groundtruth_labels.append(gt_labels)

            iou_matrix = self._iou_update_fn(det_boxes, gt_boxes, self.iou_threshold, self._invalid_val)
            if self.respect_labels:
                label_eq = _as_tensor(p["labels"], torch.int64, self.device)[:, None] == gt_labels[None, :]
                iou_matrix = torch.where(label_eq, iou_matrix, torch.full_like(iou_matrix, self._invalid_val))
            self.iou_matrix.append(iou_matrix)

    def _get_safe_item_values(self, boxes: Tensor) -> Tensor:
        boxes = _fix_empty_tensors(_as_tensor(boxes, torch.float32, self.device))
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _get_gt_classes(self) -> List[int]:
        """Unique classes present in the ground truth."""
        if len(self.groundtruth_labels) > 0:
            return torch.unique(torch.cat([x.reshape(-1) for x in self.groundtruth_labels])).tolist()
        return []

    def compute(self) -> Dict[str, Tensor]:
        """IoU over all valid (label-matched, above-threshold) box pairs."""
        flat = [mat.reshape(-1) for mat in self.iou_matrix]
        flat = torch.cat(flat) if flat else torch.zeros(0, device=self.device)
        valid = flat != self._invalid_val
        # a masked mean on the device: no host read of how many pairs are valid
        score = torch.where(valid, flat, 0.0).sum() / torch.clamp_min(valid.sum(), 1)
        results: Dict[str, Tensor] = {f"{self._iou_type}": score}

        if self.class_metrics:
            for cl in self._get_gt_classes():
                num = torch.zeros((), device=self.device)
                cnt = torch.zeros((), device=self.device)
                for mat, gt_lab in zip(self.iou_matrix, self.groundtruth_labels):
                    scores = mat[:, gt_lab == cl]
                    sel = scores != self._invalid_val
                    num = num + torch.where(sel, scores, 0.0).sum()
                    cnt = cnt + sel.sum()
                results[f"{self._iou_type}/cl_{cl}"] = num / torch.clamp_min(cnt, 1.0)
        return results
