"""Spatial Distortion Index D_s (port of ``torchmetrics_tpu/functional/image/d_s.py``).

Without ``pan_lr`` the panchromatic image is degraded as in the JAX
package: an edge pad, a uniform filter, then a bilinear resize to the MS
size. ``jax.image.resize(method="bilinear")`` antialiases when it shrinks;
its counterpart is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)``, the same triangle filter widened by the scale and
normalised over the pixels inside the image.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import _pad, _uniform_filter2d
from torchmetrics_tpu_torch.functional.image.misc import universal_image_quality_index


def _resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """``jax.image.resize(x, (*x.shape[:2], *size), method="bilinear")``: half-pixel centres, antialiased."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def _spatial_distortion_index_update(
    preds: Tensor, ms: Tensor, pan: Tensor, pan_lr: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Validate D_s inputs (the reference's shape, rank and divisibility rules)."""
    preds = torch.as_tensor(preds).to(torch.float32)
    ms = torch.as_tensor(ms).to(torch.float32)
    pan = torch.as_tensor(pan).to(torch.float32)
    pan_lr = None if pan_lr is None else torch.as_tensor(pan_lr).to(torch.float32)

    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` to have BxCxHxW shape. Got preds: {preds.shape}.")
    if ms.ndim != 4:
        raise ValueError(f"Expected `ms` to have BxCxHxW shape. Got ms: {ms.shape}.")
    if pan.ndim != 4:
        raise ValueError(f"Expected `pan` to have BxCxHxW shape. Got pan: {pan.shape}.")
    if pan_lr is not None and pan_lr.ndim != 4:
        raise ValueError(f"Expected `pan_lr` to have BxCxHxW shape. Got pan_lr: {pan_lr.shape}.")
    if preds.shape[:2] != ms.shape[:2]:
        raise ValueError(
            f"Expected `preds` and `ms` to have the same batch and channel sizes."
            f" Got preds: {preds.shape} and ms: {ms.shape}."
        )
    if preds.shape[:2] != pan.shape[:2]:
        raise ValueError(
            f"Expected `preds` and `pan` to have the same batch and channel sizes."
            f" Got preds: {preds.shape} and pan: {pan.shape}."
        )
    preds_h, preds_w = preds.shape[-2:]
    ms_h, ms_w = ms.shape[-2:]
    pan_h, pan_w = pan.shape[-2:]
    if (preds_h, preds_w) != (pan_h, pan_w):
        raise ValueError(f"Expected `preds` and `pan` to have the same size. Got {preds.shape} and {pan.shape}")
    if preds_h % ms_h != 0 or preds_w % ms_w != 0:
        raise ValueError(
            f"Expected dimensions of `preds` to be multiples of those of `ms`. Got preds: {preds.shape}, ms: {ms.shape}."
        )
    if pan_lr is not None and pan_lr.shape[-2:] != (ms_h, ms_w):
        raise ValueError(f"Expected `ms` and `pan_lr` to have the same size. Got {ms.shape} and {pan_lr.shape}.")
    return preds, ms, pan, pan_lr


def _spatial_distortion_index_compute(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Compute D_s from validated inputs."""
    length = preds.shape[1]
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(
            f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}."
        )

    if pan_lr is None:
        pad = (window_size - 1) // 2
        pan_p = _pad(pan, ((pad, window_size - 1 - pad), (pad, window_size - 1 - pad)), "edge")
        pan_degraded = _resize_bilinear(_uniform_filter2d(pan_p, (window_size, window_size)), (ms_h, ms_w))
    else:
        pan_degraded = pan_lr

    m1 = torch.stack(
        [universal_image_quality_index(ms[:, i : i + 1], pan_degraded[:, i : i + 1]) for i in range(length)]
    )
    m2 = torch.stack(
        [universal_image_quality_index(preds[:, i : i + 1], pan[:, i : i + 1]) for i in range(length)]
    )
    diff = torch.abs(m1 - m2) ** norm_order
    if reduction == "elementwise_mean":
        red = diff.mean()
    elif reduction == "sum":
        red = diff.sum()
    else:
        red = diff
    return red ** (1 / norm_order)


def spatial_distortion_index(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Spatial Distortion Index (D_s) for pan-sharpening quality."""
    if norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    preds, ms, pan, pan_lr = _spatial_distortion_index_update(preds, ms, pan, pan_lr)
    return _spatial_distortion_index_compute(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
