"""PyTorch/CUDA port of ``torchmetrics_tpu``: the ``Metric`` runtime and streaming classification.

Same module paths and names as the JAX package. Metric states live on ``cuda``
unless a metric is built with ``device=...``; the confusion matrix from 256
classes on is counted by a hand-written Hopper kernel (``csrc/confmat.cu``).
"""

from torchmetrics_tpu_torch import functional
from torchmetrics_tpu_torch.classification import (
    Accuracy,
    BinaryAccuracy,
    BinaryConfusionMatrix,
    BinaryStatScores,
    ConfusionMatrix,
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassStatScores,
    MultilabelAccuracy,
    MultilabelConfusionMatrix,
    MultilabelStatScores,
    StatScores,
)
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric

__all__ = [
    "functional",
    "Metric",
    "CompositionalMetric",
    "Accuracy",
    "BinaryAccuracy",
    "MulticlassAccuracy",
    "MultilabelAccuracy",
    "ConfusionMatrix",
    "BinaryConfusionMatrix",
    "MulticlassConfusionMatrix",
    "MultilabelConfusionMatrix",
    "StatScores",
    "BinaryStatScores",
    "MulticlassStatScores",
    "MultilabelStatScores",
]
