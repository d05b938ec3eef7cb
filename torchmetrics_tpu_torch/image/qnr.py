"""QualityWithNoReference class (port of ``torchmetrics_tpu/image/qnr.py``)."""

from __future__ import annotations

from typing import Any, Dict

from torch import Tensor

from torchmetrics_tpu_torch.functional.image.qnr import quality_with_no_reference
from torchmetrics_tpu_torch.image._pansharpening import (
    _add_pansharpening_states,
    _append_pansharpening,
    _pansharpening_inputs,
)
from torchmetrics_tpu_torch.metric import Metric


class QualityWithNoReference(Metric):
    """QNR over streaming batches. ``target`` is a dict with ``ms``, ``pan`` and optionally ``pan_lr``."""

    higher_is_better: bool = True
    is_differentiable: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        alpha: float = 1,
        beta: float = 1,
        norm_order: int = 1,
        window_size: int = 7,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(alpha, (int, float)) and alpha >= 0):
            raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
        if not (isinstance(beta, (int, float)) and beta >= 0):
            raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
        self.alpha = alpha
        self.beta = beta
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction
        _add_pansharpening_states(self)

    def update(self, preds: Tensor, target: Dict[str, Tensor]) -> None:
        """Append a batch of ``(preds, {ms, pan[, pan_lr]})``."""
        _append_pansharpening(self, preds, target)

    def compute(self) -> Tensor:
        """QNR over all accumulated images."""
        return quality_with_no_reference(
            *_pansharpening_inputs(self), self.alpha, self.beta, self.norm_order, self.window_size, self.reduction
        )
