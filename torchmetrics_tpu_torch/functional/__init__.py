"""Functional metrics ported so far (classification, clustering, image, nominal, pairwise, regression, retrieval and text: all of them; detection: the IoU family, panoptic quality)."""

from torchmetrics_tpu_torch.functional import (
    classification,
    clustering,
    detection,
    image,
    nominal,
    pairwise,
    regression,
    retrieval,
    text,
)

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
    "classification",
    "clustering",
    "detection",
    "image",
    "nominal",
    "pairwise",
    "regression",
    "retrieval",
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
]
