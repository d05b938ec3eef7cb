"""Functional audio metrics (port of ``torchmetrics_tpu/functional/audio/__init__.py``)."""

from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from torchmetrics_tpu_torch.functional.audio.sdr import signal_distortion_ratio
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
    "speech_reverberation_modulation_energy_ratio",
]
