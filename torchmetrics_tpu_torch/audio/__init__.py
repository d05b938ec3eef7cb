"""Modular audio metrics (port of ``torchmetrics_tpu/audio/__init__.py``)."""

from torchmetrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality
from torchmetrics_tpu_torch.audio.pit import PermutationInvariantTraining
from torchmetrics_tpu_torch.audio.sdr import (
    ScaleInvariantSignalDistortionRatio,
    SignalDistortionRatio,
    SourceAggregatedSignalDistortionRatio,
)
from torchmetrics_tpu_torch.audio.snr import (
    ComplexScaleInvariantSignalNoiseRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalNoiseRatio,
)
from torchmetrics_tpu_torch.audio.srmr import SpeechReverberationModulationEnergyRatio
from torchmetrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility

__all__ = [
    "ComplexScaleInvariantSignalNoiseRatio",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
    "SpeechReverberationModulationEnergyRatio",
]
