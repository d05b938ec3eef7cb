"""PyTorch/CUDA port of ``torchmetrics_tpu``: the ``Metric`` runtime, ``MetricCollection``, the aggregators, audio, all of classification, clustering, detection, all of image, multimodal (CLIPScore, CLIP-IQA), nominal association, regression, retrieval, all of text and the wrappers.

Same module paths and names as the JAX package. Metric states live on ``cuda``
unless a metric is built with ``device=...``. Hand-written Hopper kernels
(``csrc/``) count the confusion matrix from 256 classes on
(``confmat.cu``), run InceptionV3's conv epilogues (``conv_epilogue.cu``) and
the LPIPS heads (``lpips_head.cu``), and BERT's attention core (``attention.cu``)
and residual LayerNorms (``layernorm_residual.cu``), and SRMR's IIR filterbanks
(``biquad.cu``, which replaces a ``lax.scan``, not a Pallas kernel).
"""

from torchmetrics_tpu_torch import (
    aggregation,
    audio,
    classification,
    clustering,
    detection,
    functional,
    image,
    multimodal,
    nominal,
    regression,
    retrieval,
    text,
    utilities,
    wrappers,
)
from torchmetrics_tpu_torch.__about__ import __version__
from torchmetrics_tpu_torch.aggregation import (
    BaseAggregator,
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from torchmetrics_tpu_torch.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.audio import __all__ as _audio_all
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.clustering import *  # noqa: F401,F403
from torchmetrics_tpu_torch.clustering import __all__ as _clustering_all
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
from torchmetrics_tpu_torch.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.image import __all__ as _image_all
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore
from torchmetrics_tpu_torch.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.text import __all__ as _text_all
from torchmetrics_tpu_torch.wrappers import *  # noqa: F401,F403
from torchmetrics_tpu_torch.wrappers import __all__ as _wrappers_all

__all__ = [
    "aggregation",
    "audio",
    "classification",
    "clustering",
    "detection",
    "functional",
    "image",
    "multimodal",
    "nominal",
    "regression",
    "retrieval",
    "text",
    "utilities",
    "wrappers",
    "__version__",
    "Metric",
    "CompositionalMetric",
    "MetricCollection",
    "BaseAggregator",
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
    *_image_all,
    *_regression_all,
    *_retrieval_all,
    *_text_all,
    *_clustering_all,
    *_nominal_all,
    *_wrappers_all,
    *_audio_all,
    "CLIPImageQualityAssessment",
    "CLIPScore",
]
