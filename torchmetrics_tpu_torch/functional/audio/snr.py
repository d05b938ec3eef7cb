"""SNR family (port of ``torchmetrics_tpu/functional/audio/snr.py``): SNR, SI-SDR, SI-SNR, C-SI-SNR, SA-SDR."""

from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

_EPS = float(torch.finfo(torch.float32).eps)


def _zero_mean(x: Tensor) -> Tensor:
    return x - torch.mean(x, dim=-1, keepdim=True)


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """Signal-to-noise ratio in dB, per sample over the trailing time axis.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        16.1805
    """
    _check_same_shape(preds, target)
    if zero_mean:
        target, preds = _zero_mean(target), _zero_mean(preds)
    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + _EPS) / (torch.sum(noise**2, dim=-1) + _EPS)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB, per sample.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        18.403
    """
    _check_same_shape(preds, target)
    if zero_mean:
        target, preds = _zero_mean(target), _zero_mean(preds)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + _EPS) / (
        torch.sum(target**2, dim=-1, keepdim=True) + _EPS
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + _EPS) / (torch.sum(noise**2, dim=-1) + _EPS)
    return 10 * torch.log10(val)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR in dB, per sample: SI-SDR after removing each signal's mean.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR over complex spectra given as ``(..., freq, time, 2)`` real tensors or complex ``(..., freq, time)`` ones."""
    if preds.is_complex():
        preds = torch.view_as_real(preds)
    if target.is_complex():
        target = torch.view_as_real(target)
    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {preds.shape} and {target.shape}."
        )
    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)


def source_aggregated_signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    scale_invariant: bool = True,
    zero_mean: bool = False,
) -> Tensor:
    """SA-SDR over ``(..., spk, time)`` inputs: one scale shared by the speakers."""
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(f"The preds and target should have the shape (..., spk, time), but {preds.shape} found")
    if zero_mean:
        target, preds = _zero_mean(target), _zero_mean(preds)
    if scale_invariant:
        alpha = (torch.sum(preds * target, dim=(-2, -1), keepdim=True) + _EPS) / (
            torch.sum(target**2, dim=(-2, -1), keepdim=True) + _EPS
        )
        target = alpha * target
    distortion = target - preds
    val = (torch.sum(target**2, dim=(-2, -1)) + _EPS) / (torch.sum(distortion**2, dim=(-2, -1)) + _EPS)
    return 10 * torch.log10(val)
