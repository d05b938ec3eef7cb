"""Modular regression metrics (port of ``torchmetrics_tpu/regression/``)."""

from torchmetrics_tpu_torch.regression.cosine_similarity import CosineSimilarity
from torchmetrics_tpu_torch.regression.csi import CriticalSuccessIndex
from torchmetrics_tpu_torch.regression.explained_variance import ExplainedVariance
from torchmetrics_tpu_torch.regression.kl_divergence import KLDivergence
from torchmetrics_tpu_torch.regression.log_mse import LogCoshError, MeanSquaredLogError
from torchmetrics_tpu_torch.regression.mae import MeanAbsoluteError
from torchmetrics_tpu_torch.regression.mape import (
    MeanAbsolutePercentageError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from torchmetrics_tpu_torch.regression.minkowski import MinkowskiDistance
from torchmetrics_tpu_torch.regression.mse import MeanSquaredError
from torchmetrics_tpu_torch.regression.pearson import ConcordanceCorrCoef, PearsonCorrCoef
from torchmetrics_tpu_torch.regression.r2 import R2Score, RelativeSquaredError
from torchmetrics_tpu_torch.regression.spearman import KendallRankCorrCoef, SpearmanCorrCoef
from torchmetrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "CriticalSuccessIndex",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanSquaredLogError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MinkowskiDistance",
    "MeanSquaredError",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
