"""SpeechReverberationModulationEnergyRatio (port of ``torchmetrics_tpu/audio/srmr.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from torchmetrics_tpu_torch.audio._base import _AveragingAudioMetric
from torchmetrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio


class SpeechReverberationModulationEnergyRatio(_AveragingAudioMetric):
    """Mean SRMR score over every waveform seen; the filterbanks run through kernel S1 on the card.

    Example:
        >>> import torch
        >>> preds = torch.randn(8000, generator=torch.Generator().manual_seed(1))
        >>> metric = SpeechReverberationModulationEnergyRatio(8000, device="cpu")
        >>> metric.update(preds)
        >>> bool(metric.compute() > 0)
        True
    """

    is_differentiable = False

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def update(self, preds: Tensor) -> None:  # type: ignore[override]
        self._accumulate(speech_reverberation_modulation_energy_ratio(
            preds, self.fs, self.n_cochlear_filters, self.low_freq, self.min_cf, self.max_cf, self.norm, self.fast
        ))
