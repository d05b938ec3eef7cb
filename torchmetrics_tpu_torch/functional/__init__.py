"""Functional metrics ported so far (classification: all of it; detection: the IoU family, panoptic quality; image: LPIPS; text: BERTScore, InfoLM)."""

from torchmetrics_tpu_torch.functional import detection

from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.functional.detection import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
    modified_panoptic_quality,
    panoptic_quality,
)
from torchmetrics_tpu_torch.functional.image import learned_perceptual_image_patch_similarity
from torchmetrics_tpu_torch.functional.text import bert_score, infolm

__all__ = [
    "detection",
    *_classification_all,
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
    "learned_perceptual_image_patch_similarity",
    "bert_score",
    "infolm",
]
