"""Modular LPIPS metric (port of ``torchmetrics_tpu/image/lpip.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS over streaming image pairs.

    Args:
        net_type: 'vgg' | 'alex' | 'squeeze' for the built-in network, or pass
            ``net``: any callable ``(img1, img2) -> (N,)`` distances.
        reduction: 'mean' or 'sum' over the accumulated scores.
        normalize: if True inputs are [0, 1] and get rescaled to [-1, 1].
        weights_path: optional converted LPIPS checkpoint (``.npz``).
        compute_dtype: the trunk's conv dtype (bfloat16 unless given).
        kwargs: the ``Metric`` runtime's options, ``device`` among them; the
            built-in network lives on the metric's device.
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    feature_network: str = "net"
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        net: Optional[Callable] = None,
        weights_path: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net is None and net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        if net is not None:
            self.net = net
        else:
            from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor

            self.net = LPIPSExtractor(
                net_type=net_type, weights_path=weights_path, compute_dtype=compute_dtype, device=self.device
            )

        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize

        self.add_state("sum_scores", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        """Accumulate LPIPS distances for a batch of image pairs."""
        img1 = torch.as_tensor(img1, device=self.device, dtype=torch.float32)
        img2 = torch.as_tensor(img2, device=self.device, dtype=torch.float32)
        if self.normalize:
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        loss = torch.as_tensor(self.net(img1, img2), device=self.device).reshape(-1)
        self.sum_scores.add_(loss.sum())
        self.total.add_(loss.shape[0])

    def compute(self) -> Tensor:
        """Aggregate LPIPS over all batches."""
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores.clone()
