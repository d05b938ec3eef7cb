"""Image metrics (port of ``torchmetrics_tpu/image/__init__.py``)."""

from torchmetrics_tpu_torch.image.d_lambda import SpectralDistortionIndex
from torchmetrics_tpu_torch.image.d_s import SpatialDistortionIndex
from torchmetrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.inception import InceptionScore
from torchmetrics_tpu_torch.image.kid import KernelInceptionDistance
from torchmetrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.image.mifid import MemorizationInformedFrechetInceptionDistance
from torchmetrics_tpu_torch.image.perceptual_path_length import PerceptualPathLength
from torchmetrics_tpu_torch.image.psnr import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect
from torchmetrics_tpu_torch.image.qnr import QualityWithNoReference
from torchmetrics_tpu_torch.image.rase import RelativeAverageSpectralError
from torchmetrics_tpu_torch.image.rmse_sw import RootMeanSquaredErrorUsingSlidingWindow
from torchmetrics_tpu_torch.image.sam import SpectralAngleMapper
from torchmetrics_tpu_torch.image.scc import SpatialCorrelationCoefficient
from torchmetrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from torchmetrics_tpu_torch.image.tv import TotalVariation
from torchmetrics_tpu_torch.image.uqi import UniversalImageQualityIndex
from torchmetrics_tpu_torch.image.vif import VisualInformationFidelity

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PerceptualPathLength",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
