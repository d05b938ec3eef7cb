"""Functional metrics: every domain of the JAX package (detection: the IoU family and panoptic quality, as there)."""

from torchmetrics_tpu_torch.functional import (
    audio,
    classification,
    clustering,
    detection,
    image,
    multimodal,
    nominal,
    pairwise,
    regression,
    retrieval,
    segmentation,
    text,
)
from torchmetrics_tpu_torch.functional.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.audio import __all__ as _audio_all

from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.functional.clustering import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.clustering import __all__ as _clustering_all
from torchmetrics_tpu_torch.functional.detection import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
    modified_panoptic_quality,
    panoptic_quality,
)
from torchmetrics_tpu_torch.functional.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.image import __all__ as _image_all
from torchmetrics_tpu_torch.functional.multimodal import clip_image_quality_assessment, clip_score
from torchmetrics_tpu_torch.functional.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.functional.pairwise import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.pairwise import __all__ as _pairwise_all
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.functional.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.text import __all__ as _text_all

__all__ = [
    "audio",
    "classification",
    "clustering",
    "detection",
    "image",
    "multimodal",
    "nominal",
    "pairwise",
    "regression",
    "retrieval",
    "segmentation",
    "text",
    *_classification_all,
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
    *_image_all,
    *_pairwise_all,
    *_regression_all,
    *_retrieval_all,
    *_text_all,
    *_clustering_all,
    *_nominal_all,
    *_audio_all,
    "clip_image_quality_assessment",
    "clip_score",
]
