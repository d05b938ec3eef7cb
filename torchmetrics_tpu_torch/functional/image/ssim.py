"""SSIM and MS-SSIM (port of ``torchmetrics_tpu/functional/image/ssim.py``).

Gaussian/uniform windows run as depthwise convolutions in full float32
(``helper._depthwise_conv``); MS-SSIM's scale step is a 2x average pool
(``avg_pool2d``/``avg_pool3d``), the JAX package's ``reduce_window`` sum
over 4 or 8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import (
    _check_image_pair,
    _depthwise_conv,
    _gaussian_kernel_1d,
    _pad,
    _uniform_kernel_1d,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_pow


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, target = _check_image_pair(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape, got {preds.shape}"
        )
    return preds, target


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    n_sp = preds.ndim - 2  # 2 for BxCxHxW, 3 for volumetric BxCxDxHxW
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * n_sp
    if isinstance(sigma, (int, float)):
        sigma = (float(sigma),) * n_sp
    if len(kernel_size) != n_sp or len(sigma) != n_sp:
        raise ValueError(
            f"`kernel_size`/`sigma` must have {n_sp} entries for input of shape {preds.shape},"
            f" got {kernel_size} and {sigma}"
        )
    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    # the gaussian window's size comes from sigma, not `kernel_size`; the pad
    # comes from that size in both modes, so uniform-window borders reflect over it
    gauss_kernel_size = tuple(int(3.5 * s + 0.5) * 2 + 1 for s in sigma)
    if gaussian_kernel:
        kernels_1d = [_gaussian_kernel_1d(g, s) for g, s in zip(gauss_kernel_size, sigma)]
    else:
        kernels_1d = [_uniform_kernel_1d(k) for k in kernel_size]
    if n_sp == 2:
        kernel = torch.outer(kernels_1d[0], kernels_1d[1])
    else:
        kernel = torch.einsum("i,j,k->ijk", *kernels_1d)
    kernel = kernel.to(preds.device)

    pads = tuple((g - 1) // 2 for g in gauss_kernel_size)
    preds_p = _pad(preds, tuple((p, p) for p in pads), "reflect")
    target_p = _pad(target, tuple((p, p) for p in pads), "reflect")

    mu_x = _depthwise_conv(preds_p, kernel)
    mu_y = _depthwise_conv(target_p, kernel)
    mu_xx = _depthwise_conv(preds_p * preds_p, kernel)
    mu_yy = _depthwise_conv(target_p * target_p, kernel)
    mu_xy = _depthwise_conv(preds_p * target_p, kernel)

    sigma_x = torch.clamp(mu_xx - mu_x**2, min=0.0)
    sigma_y = torch.clamp(mu_yy - mu_y**2, min=0.0)
    sigma_xy = mu_xy - mu_x * mu_y

    upper = 2 * sigma_xy + c2
    lower = sigma_x + sigma_y + c2
    luminance = (2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)
    cs_map = upper / lower
    ssim_map = luminance * cs_map

    # the per-image mean is over the pad-cropped region; `return_full_image`
    # hands back the uncropped map
    crop = (Ellipsis,) + tuple(slice(p, -p if p else None) for p in pads)
    ssim_cropped = ssim_map[crop]
    ssim_vals = ssim_cropped.reshape(ssim_cropped.shape[0], -1).mean(dim=-1)

    if return_contrast_sensitivity:
        cs_map = cs_map[crop]
        return ssim_vals, cs_map.reshape(cs_map.shape[0], -1).mean(dim=-1)
    if return_full_image:
        return ssim_vals, ssim_map
    return ssim_vals


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Structural similarity index (SSIM) of ``(N, C, H, W)`` or ``(N, C, D, H, W)`` images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import structural_similarity_index_measure
        >>> preds = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(0))
        >>> structural_similarity_index_measure(preds, preds)
        tensor(1.)
    """
    preds, target = _ssim_check_inputs(preds, target)
    out = _ssim_update(
        preds,
        target,
        gaussian_kernel,
        sigma,
        kernel_size,
        data_range,
        k1,
        k2,
        return_full_image,
        return_contrast_sensitivity,
    )
    if return_full_image or return_contrast_sensitivity:
        ssim_vals, extra = out
    else:
        ssim_vals = out
    if reduction == "elementwise_mean":
        res = ssim_vals.mean()
    elif reduction == "sum":
        res = ssim_vals.sum()
    else:
        res = ssim_vals
    if return_full_image or return_contrast_sensitivity:
        return res, extra
    return res


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """Multi-scale SSIM with the standard 5-scale beta weights.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import multiscale_structural_similarity_index_measure
        >>> preds = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(0))
        >>> multiscale_structural_similarity_index_measure(preds, preds, betas=(0.2, 0.3, 0.5))
        tensor(1.)
    """
    preds, target = _ssim_check_inputs(preds, target)
    if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
        betas = tuple(float(b) for b in betas)

    kh = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    min_size = (kh - 1) * 2 ** (len(betas) - 1) + 1
    if preds.shape[-1] < min_size or preds.shape[-2] < min_size:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width should be larger"
            f" than {min_size} but got {preds.shape[-2]} and {preds.shape[-1]}"
        )

    pool = F.avg_pool2d if preds.ndim == 4 else F.avg_pool3d  # volumetric inputs pool depth too
    mcs_list = []
    sim = None
    for i in range(len(betas)):
        sim, cs = _ssim_update(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
            return_contrast_sensitivity=True,
        )
        mcs_list.append(cs)
        if i < len(betas) - 1:
            preds = pool(preds, 2)
            target = pool(target, 2)

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list, dim=0)  # (S, N)
    if normalize == "relu":
        mcs_stack = torch.relu(mcs_stack)
    betas_arr = torch.tensor(betas, dtype=torch.float32, device=mcs_stack.device)[:, None]
    # _safe_pow: finite gradient at the relu zeros, the same forward values
    # (NaN for negative bases under normalize=None)
    mcs_weighted = _safe_pow(mcs_stack, betas_arr)
    out = torch.prod(mcs_weighted, dim=0)
    if reduction == "elementwise_mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out
