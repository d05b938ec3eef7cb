"""PSNR and PSNR-B (port of ``torchmetrics_tpu/functional/image/psnr.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _psnr_compute(
    sum_squared_error: Tensor,
    num_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    return psnr_base_e * (10 / torch.log(torch.tensor(base, dtype=torch.float32, device=psnr_base_e.device)))


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if dim is None:
        sum_squared_error = torch.sum(torch.square(preds - target))
        num_obs = torch.full((), float(target.numel()), device=target.device)
    else:
        diff = preds - target
        sum_squared_error = torch.sum(diff * diff, dim=dim)
        num_obs = torch.full((), float(_prod_axis(target.shape, dim)), device=target.device)
        num_obs = torch.broadcast_to(num_obs, sum_squared_error.shape)
    return sum_squared_error, num_obs


def _prod_axis(shape, dim) -> int:
    dims = (dim,) if isinstance(dim, int) else dim
    return math.prod(shape[d] for d in dims)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> peak_signal_noise_ratio(preds, target)
        tensor(2.5527)
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = torch.tensor(data_range[1] - data_range[0], dtype=torch.float32, device=target.device)
    else:
        data_range = torch.tensor(float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    psnr = _psnr_compute(sum_squared_error, num_obs, data_range.to(torch.float32), base=base)
    if reduction == "elementwise_mean" and psnr.ndim > 0:
        return psnr.mean()
    if reduction == "sum" and psnr.ndim > 0:
        return psnr.sum()
    return psnr


def _psnrb_compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocking effect factor of a single-channel image batch (N, 1, H, W)."""
    height, width = x.shape[-2], x.shape[-1]
    h = torch.arange(width - 1, device=x.device)
    h_b = h[(h + 1) % block_size == 0]
    h_bc = h[(h + 1) % block_size != 0]
    v = torch.arange(height - 1, device=x.device)
    v_b = v[(v + 1) % block_size == 0]
    v_bc = v[(v + 1) % block_size != 0]

    d_b = torch.sum((x[..., :, h_b] - x[..., :, h_b + 1]) ** 2) + torch.sum((x[..., v_b, :] - x[..., v_b + 1, :]) ** 2)
    d_bc = torch.sum((x[..., :, h_bc] - x[..., :, h_bc + 1]) ** 2) + torch.sum(
        (x[..., v_bc, :] - x[..., v_bc + 1, :]) ** 2
    )
    # the reference's normalization counts are analytic formulas, not the
    # actual index counts: kept as they are
    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = torch.log2(torch.tensor(float(block_size))) / torch.log2(torch.tensor(float(min(height, width))))
    return torch.where(d_b > d_bc, t.to(x.device) * (d_b - d_bc), torch.zeros_like(d_b))


def peak_signal_noise_ratio_with_blocked_effect(
    preds: Tensor,
    target: Tensor,
    block_size: int = 8,
) -> Tensor:
    """PSNR-B: PSNR adjusted by the blocking effect factor (single-channel images)."""
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    _check_same_shape(preds, target)
    data_range = target.max() - target.min()
    sum_squared_error, num_obs = _psnr_update(preds, target)
    bef = _psnrb_compute_bef(preds, block_size=block_size)
    mse = sum_squared_error / num_obs
    return 10.0 * torch.log10(_psnrb_numerator(data_range) / (mse + bef))


def _psnrb_numerator(data_range: Tensor) -> Tensor:
    """``data_range ** 2``, or 1 for low-range data (reference ``psnrb.py:84-87``)."""
    return torch.where(data_range > 2, data_range**2, torch.ones_like(data_range))
