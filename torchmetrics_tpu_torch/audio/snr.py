"""SNR metric classes (port of ``torchmetrics_tpu/audio/snr.py``)."""

from __future__ import annotations

from typing import Any

from torch import Tensor

from torchmetrics_tpu_torch.audio._base import _AveragingAudioMetric
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)


def _check_zero_mean(zero_mean: Any) -> None:
    if not isinstance(zero_mean, bool):
        raise ValueError(f"Expected argument `zero_mean` to be an bool, but got {zero_mean}")


class SignalNoiseRatio(_AveragingAudioMetric):
    """Mean signal-to-noise ratio in dB.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> round(float(snr(preds, target)), 4)
        16.1805
    """

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_zero_mean(zero_mean)
        self.zero_mean = zero_mean

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_AveragingAudioMetric):
    """Mean scale-invariant signal-to-noise ratio in dB.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> round(float(si_snr(preds, target)), 4)
        15.0918
    """

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_noise_ratio(preds=preds, target=target)


class ComplexScaleInvariantSignalNoiseRatio(_AveragingAudioMetric):
    """Mean C-SI-SNR over complex spectra, ``(..., freq, time, 2)`` real or ``(..., freq, time)`` complex."""

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_zero_mean(zero_mean)
        self.zero_mean = zero_mean

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
