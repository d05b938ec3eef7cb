"""Functional clustering metrics (port of ``torchmetrics_tpu/functional/clustering/``)."""

from torchmetrics_tpu_torch.functional.clustering.extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.intrinsic import (
    calinski_harabasz_score,
    davies_bouldin_score,
    dunn_index,
)
from torchmetrics_tpu_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_entropy,
    calculate_generalized_mean,
    calculate_pair_cluster_confusion_matrix,
)

__all__ = [
    "adjusted_mutual_info_score",
    "adjusted_rand_score",
    "calculate_contingency_matrix",
    "calculate_entropy",
    "calculate_generalized_mean",
    "calculate_pair_cluster_confusion_matrix",
    "calinski_harabasz_score",
    "completeness_score",
    "davies_bouldin_score",
    "dunn_index",
    "fowlkes_mallows_index",
    "homogeneity_score",
    "mutual_info_score",
    "normalized_mutual_info_score",
    "rand_score",
    "v_measure_score",
]
