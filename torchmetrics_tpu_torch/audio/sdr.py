"""SDR metric classes (port of ``torchmetrics_tpu/audio/sdr.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torch import Tensor

from torchmetrics_tpu_torch.audio._base import _AveragingAudioMetric
from torchmetrics_tpu_torch.audio.snr import _check_zero_mean
from torchmetrics_tpu_torch.functional.audio.sdr import signal_distortion_ratio
from torchmetrics_tpu_torch.functional.audio.snr import (
    scale_invariant_signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)


class SignalDistortionRatio(_AveragingAudioMetric):
    """Mean SDR in dB (the distortion-filter form: a Toeplitz solve on the device)."""

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)


class ScaleInvariantSignalDistortionRatio(_AveragingAudioMetric):
    """Mean SI-SDR in dB.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> round(float(si_sdr(preds, target)), 4)
        18.403
    """

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_zero_mean(zero_mean)
        self.zero_mean = zero_mean

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class SourceAggregatedSignalDistortionRatio(_AveragingAudioMetric):
    """Mean SA-SDR over ``(..., spk, time)`` inputs."""

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)
