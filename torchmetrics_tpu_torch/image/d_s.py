"""SpatialDistortionIndex class (port of ``torchmetrics_tpu/image/d_s.py``)."""

from __future__ import annotations

from typing import Any, Dict

from torch import Tensor

from torchmetrics_tpu_torch.functional.image.d_s import _spatial_distortion_index_compute
from torchmetrics_tpu_torch.image._pansharpening import (
    _add_pansharpening_states,
    _append_pansharpening,
    _pansharpening_inputs,
)
from torchmetrics_tpu_torch.metric import Metric


class SpatialDistortionIndex(Metric):
    """D_s spatial distortion index over streaming batches.

    ``update(preds, target)`` takes ``target`` as a dict with the keys ``ms``,
    ``pan`` and optionally ``pan_lr`` (the reference's protocol).
    """

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(norm_order, int) and norm_order > 0):
            raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
        if not (isinstance(window_size, int) and window_size > 0):
            raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction
        _add_pansharpening_states(self)

    def update(self, preds: Tensor, target: Dict[str, Tensor]) -> None:
        """Append a batch of ``(preds, {ms, pan[, pan_lr]})``."""
        _append_pansharpening(self, preds, target)

    def compute(self) -> Tensor:
        """D_s over all accumulated images."""
        return _spatial_distortion_index_compute(
            *_pansharpening_inputs(self), self.norm_order, self.window_size, self.reduction
        )
