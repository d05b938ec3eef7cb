"""Modular Panoptic Quality metrics (port of ``torchmetrics_tpu/detection/panoptic_qualities.py``).

Fixed-shape ``(num_categories,)`` sum states, added into in place.
"""

from __future__ import annotations

from typing import Any, Collection, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.detection.panoptic_qualities import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _prepocess_inputs,
    _validate_inputs,
)
from torchmetrics_tpu_torch.metric import Metric


class PanopticQuality(Metric):
    """Panoptic Quality over streaming batches of panoptic segmentations.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PanopticQuality
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
        >>> metric = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.5463
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    _modified_stuffs: Optional[Collection[int]] = None

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things, stuffs = _parse_categories(things, stuffs)
        self.things = things
        self.stuffs = stuffs
        self.void_color = _get_void_color(things, stuffs)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
        self.allow_unknown_preds_category = allow_unknown_preds_category

        num_categories = len(things) + len(stuffs)
        self.add_state("iou_sum", default=torch.zeros(num_categories, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("true_positives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", default=torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-category segment statistics from a batch."""
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        _validate_inputs(preds, target)
        flatten_preds = _prepocess_inputs(
            self.things, self.stuffs, preds, self.void_color, self.allow_unknown_preds_category
        )
        flatten_target = _prepocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            flatten_preds,
            flatten_target,
            self.cat_id_to_continuous_id,
            self.void_color,
            modified_metric_stuffs=self._modified_stuffs,
        )
        self.iou_sum += iou_sum
        self.true_positives += tp
        self.false_positives += fp
        self.false_negatives += fn

    def compute(self) -> Tensor:
        """Aggregate PQ over categories."""
        return _panoptic_quality_compute(self.iou_sum, self.true_positives, self.false_positives, self.false_negatives)


class ModifiedPanopticQuality(PanopticQuality):
    """Modified Panoptic Quality (relaxed stuff matching, Porzi et al.).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> metric = ModifiedPanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.7667
    """

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(things, stuffs, allow_unknown_preds_category, **kwargs)
        self._modified_stuffs = self.stuffs
