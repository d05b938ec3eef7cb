"""PyTorch/CUDA port of ``torchmetrics_tpu``: the ``Metric`` runtime, ``MetricCollection``, the aggregators, all of classification, detection, FID, LPIPS, BERTScore and InfoLM.

Same module paths and names as the JAX package. Metric states live on ``cuda``
unless a metric is built with ``device=...``. Hand-written Hopper kernels
(``csrc/``) count the confusion matrix from 256 classes on
(``confmat.cu``), run InceptionV3's conv epilogues (``conv_epilogue.cu``) and
the LPIPS heads (``lpips_head.cu``), and BERT's attention core (``attention.cu``)
and residual LayerNorms (``layernorm_residual.cu``).
"""

from torchmetrics_tpu_torch import detection, functional
from torchmetrics_tpu_torch.aggregation import (
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.detection import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
    MeanAveragePrecision,
    ModifiedPanopticQuality,
    PanopticQuality,
)
from torchmetrics_tpu_torch.image import FrechetInceptionDistance, LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.text import BERTScore, InfoLM
from torchmetrics_tpu_torch.wrappers import Running

__all__ = [
    "detection",
    "functional",
    "Metric",
    "CompositionalMetric",
    "MetricCollection",
    "Running",
    "CatMetric",
    "MaxMetric",
    "MeanMetric",
    "MinMetric",
    "RunningMean",
    "RunningSum",
    "SumMetric",
    *_classification_all,
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
    "FrechetInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "BERTScore",
    "InfoLM",
]
