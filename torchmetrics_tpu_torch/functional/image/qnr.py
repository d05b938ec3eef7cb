"""Quality with No Reference, QNR (port of ``torchmetrics_tpu/functional/image/qnr.py``).

``QNR = (1 - D_lambda)^alpha * (1 - D_s)^beta``.
"""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.image.d_s import spatial_distortion_index
from torchmetrics_tpu_torch.functional.image.misc import spectral_distortion_index


def quality_with_no_reference(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    alpha: float = 1,
    beta: float = 1,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Quality with No Reference (QNR) for pan-sharpening."""
    if not (isinstance(alpha, (int, float)) and alpha >= 0):
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not (isinstance(beta, (int, float)) and beta >= 0):
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, norm_order, reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
