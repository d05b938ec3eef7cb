"""Detection metrics (port of ``torchmetrics_tpu/detection/__init__.py``)."""

from torchmetrics_tpu_torch.detection.ciou import CompleteIntersectionOverUnion
from torchmetrics_tpu_torch.detection.diou import DistanceIntersectionOverUnion
from torchmetrics_tpu_torch.detection.giou import GeneralizedIntersectionOverUnion
from torchmetrics_tpu_torch.detection.iou import IntersectionOverUnion
from torchmetrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
from torchmetrics_tpu_torch.detection.panoptic_qualities import ModifiedPanopticQuality, PanopticQuality

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
