"""Functional image metrics (port of ``torchmetrics_tpu/functional/image/__init__.py``)."""

from torchmetrics_tpu_torch.functional.image.d_s import spatial_distortion_index
from torchmetrics_tpu_torch.functional.image.gradients import image_gradients
from torchmetrics_tpu_torch.functional.image.lpips import learned_perceptual_image_patch_similarity
from torchmetrics_tpu_torch.functional.image.misc import (
    error_relative_global_dimensionless_synthesis,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spatial_correlation_coefficient,
    spectral_angle_mapper,
    spectral_distortion_index,
    total_variation,
    universal_image_quality_index,
)
from torchmetrics_tpu_torch.functional.image.psnr import (
    peak_signal_noise_ratio,
    peak_signal_noise_ratio_with_blocked_effect,
)
from torchmetrics_tpu_torch.functional.image.qnr import quality_with_no_reference
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.vif import visual_information_fidelity
from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "learned_perceptual_image_patch_similarity",
    "perceptual_path_length",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
