"""Functional metrics ported so far (classification: stat scores, accuracy, confusion matrix; image: LPIPS; text: BERTScore, InfoLM)."""

from torchmetrics_tpu_torch.functional.classification import (
    accuracy,
    binary_accuracy,
    binary_confusion_matrix,
    binary_stat_scores,
    confusion_matrix,
    multiclass_accuracy,
    multiclass_confusion_matrix,
    multiclass_stat_scores,
    multilabel_accuracy,
    multilabel_confusion_matrix,
    multilabel_stat_scores,
    stat_scores,
)
from torchmetrics_tpu_torch.functional.image import learned_perceptual_image_patch_similarity
from torchmetrics_tpu_torch.functional.text import bert_score, infolm

__all__ = [
    "accuracy",
    "binary_accuracy",
    "multiclass_accuracy",
    "multilabel_accuracy",
    "confusion_matrix",
    "binary_confusion_matrix",
    "multiclass_confusion_matrix",
    "multilabel_confusion_matrix",
    "stat_scores",
    "binary_stat_scores",
    "multiclass_stat_scores",
    "multilabel_stat_scores",
    "learned_perceptual_image_patch_similarity",
    "bert_score",
    "infolm",
]
