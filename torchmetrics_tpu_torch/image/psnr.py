"""PSNR and PSNR-B classes (port of ``torchmetrics_tpu/image/psnr.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.psnr import (
    _psnr_compute,
    _psnr_update,
    _psnrb_compute_bef,
    _psnrb_numerator,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """Peak Signal-to-Noise Ratio over streaming batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> psnr = PeakSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> psnr(preds, target)
        tensor(2.5527)
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                # tracking the target's min and max cannot be reduced per dim
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(float("-inf")), dist_reduce_fx="max")
            self.clamping_fn = None
        elif isinstance(data_range, tuple):
            self.add_state("data_range", default=torch.tensor(data_range[1] - data_range[0]), dist_reduce_fx="mean")
            self.clamping_fn = lambda x: torch.clamp(x, data_range[0], data_range[1])
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
            self.clamping_fn = None
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, (list, tuple)) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate squared error and element counts."""
        preds = torch.as_tensor(preds, device=self.device).to(torch.float32)
        target = torch.as_tensor(target, device=self.device).to(torch.float32)
        if self.clamping_fn is not None:
            preds = self.clamping_fn(preds)
            target = self.clamping_fn(target)
        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error += sum_squared_error
            self.total += num_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(num_obs)

    def compute(self) -> Tensor:
        """PSNR over all accumulated batches."""
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        psnr = _psnr_compute(sum_squared_error, total, data_range, base=self.base)
        if self.dim is not None and psnr.ndim > 0:
            if self.reduction == "elementwise_mean":
                return psnr.mean()
            if self.reduction == "sum":
                return psnr.sum()
        return psnr


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B: PSNR with a blocking-effect penalty (single-channel images)."""

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("bef", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("data_range", default=torch.tensor(0.0), dist_reduce_fx="max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate squared error, blocking-effect factor and data range."""
        preds = torch.as_tensor(preds, device=self.device).to(torch.float32)
        target = torch.as_tensor(target, device=self.device).to(torch.float32)
        sum_squared_error, num_obs = _psnr_update(preds, target)
        self.sum_squared_error += sum_squared_error
        self.total += num_obs
        self.bef += _psnrb_compute_bef(preds, block_size=self.block_size)
        self.data_range = torch.maximum(self.data_range, target.max() - target.min())

    def compute(self) -> Tensor:
        """PSNR-B over all accumulated batches."""
        mse = self.sum_squared_error / self.total
        return 10.0 * torch.log10(_psnrb_numerator(self.data_range) / (mse + self.bef))
