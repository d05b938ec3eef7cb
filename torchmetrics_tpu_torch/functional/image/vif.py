"""Pixel-based Visual Information Fidelity (port of ``torchmetrics_tpu/functional/image/vif.py``).

The JAX package maps a one-channel function over the channels; here every
channel goes through one depthwise convolution (``helper._depthwise_conv``),
which is the same arithmetic channel by channel. Four scales of valid convolutions in
full float32, each after the first decimated by ``[::2, ::2]``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import _depthwise_conv


def _vif_filter(win_size: int, sigma: float) -> Tensor:
    coords = torch.arange(win_size, dtype=torch.float32) - (win_size - 1) / 2
    g = coords**2
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _conv2d_valid(x: Tensor, kernel: Tensor) -> Tensor:
    """Valid convolution of every channel of ``(N, C, H, W)`` with one 2-D kernel, in full float32."""
    return _depthwise_conv(x, kernel)


def _vif_per_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """VIF of each image and channel of ``(N, C, H, W)`` inputs: ``(N, C)``."""
    eps = 1e-10
    preds_vif = torch.zeros(preds.shape[:2], dtype=torch.float32, device=preds.device)
    target_vif = torch.zeros(preds.shape[:2], dtype=torch.float32, device=preds.device)
    for scale in range(4):
        n = int(2.0 ** (4 - scale) + 1)
        kernel = _vif_filter(n, n / 5).to(preds.device)

        if scale > 0:
            target = _conv2d_valid(target, kernel)[:, :, ::2, ::2]
            preds = _conv2d_valid(preds, kernel)[:, :, ::2, ::2]

        mu_target = _conv2d_valid(target, kernel)
        mu_preds = _conv2d_valid(preds, kernel)
        mu_target_sq = mu_target**2
        mu_preds_sq = mu_preds**2
        mu_target_preds = mu_target * mu_preds

        sigma_target_sq = torch.clamp(_conv2d_valid(target**2, kernel) - mu_target_sq, min=0.0)
        sigma_preds_sq = torch.clamp(_conv2d_valid(preds**2, kernel) - mu_preds_sq, min=0.0)
        sigma_target_preds = _conv2d_valid(target * preds, kernel) - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds

        # the reference's sequential mask rewrites, in order
        zero = torch.zeros_like(g)
        mask1 = sigma_target_sq < eps
        g = torch.where(mask1, zero, g)
        sigma_v_sq = torch.where(mask1, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask1, zero, sigma_target_sq)

        mask2 = sigma_preds_sq < eps
        g = torch.where(mask2, zero, g)
        sigma_v_sq = torch.where(mask2, zero, sigma_v_sq)

        mask3 = g < 0
        sigma_v_sq = torch.where(mask3, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask3, zero, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_vif_scale = torch.log10(1.0 + (g**2.0) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        preds_vif = preds_vif + torch.sum(preds_vif_scale, dim=(2, 3))
        target_vif = target_vif + torch.sum(torch.log10(1.0 + sigma_target_sq / sigma_n_sq), dim=(2, 3))
    return preds_vif / target_vif


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """Pixel-based Visual Information Fidelity (VIF-p).

    Args:
        preds: predicted images ``(N, C, H, W)``; ``(H, W)`` at least 41x41.
        target: ground-truth images, same shape.
        sigma_n_sq: variance of the visual noise.
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!"
        )
    if target.shape[-1] < 41 or target.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-1]}x{target.shape[-2]}!"
        )
    return torch.mean(_vif_per_channel(preds, target, sigma_n_sq))
