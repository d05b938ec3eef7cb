"""Functional multimodal metrics (port of ``torchmetrics_tpu/functional/multimodal/__init__.py``)."""

from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
from torchmetrics_tpu_torch.functional.multimodal.clip_score import clip_score

__all__ = ["clip_image_quality_assessment", "clip_score"]
