"""Classification functionals ported so far: stat scores, accuracy, confusion matrix."""

from torchmetrics_tpu_torch.functional.classification.accuracy import (
    accuracy,
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
    stat_scores,
)

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
]
