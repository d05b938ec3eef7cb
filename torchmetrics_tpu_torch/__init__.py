"""PyTorch/CUDA port of ``torchmetrics_tpu``: the ``Metric`` runtime, streaming classification, FID, LPIPS, BERTScore and InfoLM.

Same module paths and names as the JAX package. Metric states live on ``cuda``
unless a metric is built with ``device=...``. Hand-written Hopper kernels
(``csrc/``) count the confusion matrix from 256 classes on
(``confmat.cu``), run InceptionV3's conv epilogues (``conv_epilogue.cu``) and
the LPIPS heads (``lpips_head.cu``), and BERT's attention core (``attention.cu``)
and residual LayerNorms (``layernorm_residual.cu``).
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
from torchmetrics_tpu_torch.image import FrechetInceptionDistance, LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.text import BERTScore, InfoLM

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
    "FrechetInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "BERTScore",
    "InfoLM",
]
