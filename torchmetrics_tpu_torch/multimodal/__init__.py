"""Modular multimodal metrics (port of ``torchmetrics_tpu/multimodal/__init__.py``)."""

from torchmetrics_tpu_torch.multimodal.clip_iqa import CLIPImageQualityAssessment
from torchmetrics_tpu_torch.multimodal.clip_score import CLIPScore

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
