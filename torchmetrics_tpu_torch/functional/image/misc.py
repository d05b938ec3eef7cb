"""UQI, SAM, ERGAS, RASE, RMSE-SW, TV, SCC and D_lambda (port of ``torchmetrics_tpu/functional/image/misc.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import (
    _check_image_pair,
    _depthwise_conv2d,
    _gaussian_kernel_1d,
    _pad,
    _uniform_filter2d_same,
)


def _reduce(values: Tensor, reduction: Optional[str]) -> Tensor:
    if reduction == "elementwise_mean":
        return values.mean()
    if reduction == "sum":
        return values.sum()
    return values


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Universal image quality index (UQI, SSIM with C1 = C2 = 0).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import universal_image_quality_index
        >>> preds = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(0))
        >>> round(float(universal_image_quality_index(preds, preds)), 4)
        1.0
    """
    preds, target = _check_image_pair(preds, target)
    kh = _gaussian_kernel_1d(kernel_size[0], sigma[0])
    kw = _gaussian_kernel_1d(kernel_size[1], sigma[1])
    kernel = torch.outer(kh, kw).to(preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = _pad(preds, ((pad_h, pad_h), (pad_w, pad_w)), "reflect")
    target_p = _pad(target, ((pad_h, pad_h), (pad_w, pad_w)), "reflect")

    mu_x = _depthwise_conv2d(preds_p, kernel)
    mu_y = _depthwise_conv2d(target_p, kernel)
    sigma_x = _depthwise_conv2d(preds_p**2, kernel) - mu_x**2
    sigma_y = _depthwise_conv2d(target_p**2, kernel) - mu_y**2
    sigma_xy = _depthwise_conv2d(preds_p * target_p, kernel) - mu_x * mu_y

    upper = 2 * sigma_xy
    lower = sigma_x + sigma_y
    eps = torch.finfo(torch.float32).eps
    uqi_map = (2 * mu_x * mu_y * upper) / ((mu_x**2 + mu_y**2) * lower + eps)
    uqi_map = uqi_map[..., pad_h : -pad_h if pad_h else None, pad_w : -pad_w if pad_w else None]
    return _reduce(uqi_map.reshape(uqi_map.shape[0], -1).mean(dim=-1), reduction)


def spectral_angle_mapper(
    preds: Tensor,
    target: Tensor,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Spectral angle mapper (radians) between multispectral images (N, C, H, W)."""
    preds, target = _check_image_pair(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape, got {preds.shape}")
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1.0, 1.0))
    return _reduce(sam_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: float = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS for pan-sharpening quality (N, C, H, W)."""
    preds, target = _check_image_pair(preds, target)
    b, c, h, w = preds.shape
    preds_f = preds.reshape(b, c, -1)
    target_f = target.reshape(b, c, -1)
    diff = preds_f - target_f
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target_f, dim=2)
    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return _reduce(ergas_score, reduction)


def relative_average_spectral_error(
    preds: Tensor,
    target: Tensor,
    window_size: int = 8,
) -> Tensor:
    """RASE via sliding-window RMSE (N, C, H, W).

    The reference's protocol: batch-averaged RMSE and window-mean maps (the
    latter divided by ``window_size**2`` a second time), the channel mean,
    and a ``round(ws/2)`` border crop before the final spatial mean.
    """
    preds, target = _check_image_pair(preds, target)
    rmse_map, target_mu = _rmse_sw_maps(preds, target, window_size)
    n = preds.shape[0]
    rmse_mean = torch.sum(rmse_map, dim=0) / n  # (C, H, W)
    target_mean = torch.sum(target_mu / window_size**2, dim=0) / n
    target_mean = target_mean.mean(dim=0)  # mean over channels -> (H, W)
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_mean**2, dim=0))
    crop = round(window_size / 2)
    return torch.mean(rase_map[crop:-crop, crop:-crop])


def _rmse_sw_maps(preds: Tensor, target: Tensor, window_size: int) -> Tuple[Tensor, Tensor]:
    mu_t = _uniform_filter2d_same(target, window_size, mode="symmetric")
    diff2 = (preds - target) ** 2
    mse_map = _uniform_filter2d_same(diff2, window_size, mode="symmetric")
    return torch.sqrt(mse_map), mu_t


def root_mean_squared_error_using_sliding_window(
    preds: Tensor,
    target: Tensor,
    window_size: int = 8,
    return_rmse_map: bool = False,
    *,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """RMSE over sliding windows (N, C, H, W).

    Border windows are cropped by ``round(ws/2)`` before averaging. With
    ``return_rmse_map`` the image-averaged full-resolution RMSE map is
    returned beside the value.
    """
    preds, target = _check_image_pair(preds, target)
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
    rmse_map, _ = _rmse_sw_maps(preds, target, window_size)
    crop = round(window_size / 2)
    cropped = rmse_map[:, :, crop:-crop, crop:-crop]
    out = _reduce(cropped.reshape(cropped.shape[0], -1).mean(dim=-1), reduction)
    if return_rmse_map:
        return out, rmse_map.mean(dim=0)
    return out


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Total variation of an image batch (N, C, H, W).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import total_variation
        >>> img = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> total_variation(img).shape
        torch.Size([])
    """
    img = torch.as_tensor(img).to(torch.float32)
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {img.shape}")
    diff1 = torch.abs(img[..., 1:, :] - img[..., :-1, :]).sum(dim=(1, 2, 3))
    diff2 = torch.abs(img[..., :, 1:] - img[..., :, :-1]).sum(dim=(1, 2, 3))
    res = diff1 + diff2
    if reduction == "mean":
        return res.mean()
    if reduction == "sum":
        return res.sum()
    if reduction is None or reduction == "none":
        return res
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def spatial_correlation_coefficient(
    preds: Tensor,
    target: Tensor,
    hp_filter: Optional[Tensor] = None,
    window_size: int = 8,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Spatial correlation coefficient.

    The reference's sewar-derived protocol: a symmetric-padded,
    flipped-kernel signal convolution scaled by 2 for the high-pass
    Laplacian, zero-padded same-size variance/covariance windows, and a
    correlation of zero where the local variances vanish.
    """
    preds, target = _check_image_pair(preds, target)
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    if hp_filter is None:
        hp_filter = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]])
    hp_filter = torch.as_tensor(hp_filter).to(device=preds.device, dtype=torch.float32)
    kh, kw = hp_filter.shape
    # signal convolution: flipped kernel, symmetric (edge-inclusive) padding
    lead_h, trail_h = (kh - 1) // 2, kh - 1 - (kh - 1) // 2
    lead_w, trail_w = (kw - 1) // 2, kw - 1 - (kw - 1) // 2
    pads = ((lead_h, trail_h), (lead_w, trail_w))
    flipped = torch.flip(hp_filter, (0, 1))
    preds_hp = _depthwise_conv2d(_pad(preds, pads, "symmetric"), flipped) * 2.0
    target_hp = _depthwise_conv2d(_pad(target, pads, "symmetric"), flipped) * 2.0

    mu_x = _uniform_filter2d_same(preds_hp, window_size, mode="constant")
    mu_y = _uniform_filter2d_same(target_hp, window_size, mode="constant")
    var_x = _uniform_filter2d_same(preds_hp**2, window_size, mode="constant") - mu_x**2
    var_y = _uniform_filter2d_same(target_hp**2, window_size, mode="constant") - mu_y**2
    cov_xy = _uniform_filter2d_same(preds_hp * target_hp, window_size, mode="constant") - mu_x * mu_y

    denom = torch.sqrt(torch.clamp(var_x, min=0.0)) * torch.sqrt(torch.clamp(var_y, min=0.0))
    positive = denom > 0
    scc_map = torch.where(positive, cov_xy / torch.where(positive, denom, torch.ones_like(denom)), 0.0)
    per_image = scc_map.reshape(scc_map.shape[0], -1).mean(dim=-1)
    if reduction in ("none", None):
        return per_image
    if reduction == "sum":
        return per_image.sum()
    return scc_map.mean()


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D_lambda spectral distortion index for pan-sharpening (N, C, H, W).

    ``preds`` and ``target`` may differ in spatial size: UQI is computed
    within each image between pairs of its bands. The loop over the
    ``C * (C - 1)`` ordered pairs keeps the JAX package's order.
    """
    uqi = universal_image_quality_index
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if preds.ndim != 4 or target.ndim != 4:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape, got {preds.shape} and {target.shape}"
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {preds.shape} and target: {target.shape}."
        )
    length = preds.shape[1]
    if length < 2:
        raise ValueError("Expected at least 2 spectral bands")
    one = torch.ones((), device=preds.device)
    rows1, rows2 = [], []
    for k in range(length):
        r1, r2 = [], []
        for r in range(length):
            if k == r:
                r1.append(one)
                r2.append(one)
            else:
                r1.append(uqi(target[:, k : k + 1], target[:, r : r + 1], reduction="elementwise_mean"))
                r2.append(uqi(preds[:, k : k + 1], preds[:, r : r + 1], reduction="elementwise_mean"))
        rows1.append(torch.stack(r1))
        rows2.append(torch.stack(r2))
    m1 = torch.stack(rows1)
    m2 = torch.stack(rows2)
    diff = torch.abs(m1 - m2) ** p
    # the diagonal is excluded
    total = torch.sum(diff) - torch.sum(torch.diagonal(diff))
    return (total / (length * (length - 1))) ** (1.0 / p)
