"""SSIM and MS-SSIM classes (port of ``torchmetrics_tpu/image/ssim.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.ssim import (
    _ssim_check_inputs,
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_VALID_REDUCTION = ("elementwise_mean", "sum", "none", None)


def _add_similarity_states(metric: Metric, reduction: Optional[str]) -> None:
    if reduction not in _VALID_REDUCTION:
        raise ValueError(f"Argument `reduction` must be one of {_VALID_REDUCTION}, but got {reduction}")
    if reduction in ("elementwise_mean", "sum"):
        metric.add_state("similarity", default=torch.tensor(0.0), dist_reduce_fx="sum")
    else:
        metric.add_state("similarity", default=[], dist_reduce_fx="cat")
    metric.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")


def _accumulate_similarity(metric: Metric, similarity: Tensor) -> None:
    if metric.reduction in ("elementwise_mean", "sum"):
        metric.similarity += similarity.sum()
        metric.total += similarity.shape[0]
    else:
        metric.similarity.append(similarity)


def _similarity_value(metric: Metric) -> Tensor:
    if metric.reduction == "elementwise_mean":
        return metric.similarity / metric.total
    if metric.reduction == "sum":
        return metric.similarity.clone()
    return dim_zero_cat(metric.similarity)


class StructuralSimilarityIndexMeasure(Metric):
    """Structural Similarity Index Measure over streaming batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> preds = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(0))
        >>> ssim = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> ssim(preds, preds)
        tensor(1.)
    """

    higher_is_better: bool = True
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _add_similarity_states(self, reduction)
        if return_full_image:
            self.add_state("image_return", default=[], dist_reduce_fx="cat")

        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image SSIM values."""
        preds, target = _ssim_check_inputs(torch.as_tensor(preds, device=self.device),
                                           torch.as_tensor(target, device=self.device))
        out = structural_similarity_index_measure(
            preds,
            target,
            self.gaussian_kernel,
            self.sigma,
            self.kernel_size,
            None,  # per-image values; reduced in compute
            self.data_range,
            self.k1,
            self.k2,
            self.return_full_image,
            self.return_contrast_sensitivity,
        )
        if isinstance(out, tuple):
            similarity, extra = out
            if self.return_full_image:
                self.image_return.append(extra)
        else:
            similarity = out
        _accumulate_similarity(self, similarity)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """Aggregate SSIM over all batches."""
        similarity = _similarity_value(self)
        if self.return_full_image:
            return similarity, dim_zero_cat(self.image_return)
        return similarity


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """Multi-scale SSIM over streaming batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
        >>> preds = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(0))
        >>> ms_ssim = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, betas=(0.2, 0.3, 0.5), device="cpu")
        >>> ms_ssim(preds, preds)
        tensor(1.)
    """

    higher_is_better: bool = True
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _add_similarity_states(self, reduction)
        if not isinstance(kernel_size, (Sequence, int)):
            raise ValueError("Argument `kernel_size` expected to be an sequence or an int")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")

        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = tuple(float(b) for b in betas)
        self.normalize = normalize

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-image MS-SSIM values."""
        preds, target = _ssim_check_inputs(torch.as_tensor(preds, device=self.device),
                                           torch.as_tensor(target, device=self.device))
        similarity = multiscale_structural_similarity_index_measure(
            preds,
            target,
            self.gaussian_kernel,
            self.sigma,
            self.kernel_size,
            None,
            self.data_range,
            self.k1,
            self.k2,
            self.betas,
            self.normalize,
        )
        _accumulate_similarity(self, similarity)

    def compute(self) -> Tensor:
        """Aggregate MS-SSIM over all batches."""
        return _similarity_value(self)
