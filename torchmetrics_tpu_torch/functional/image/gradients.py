"""Image gradients (port of ``torchmetrics_tpu/functional/image/gradients.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import Tensor


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Compute (dy, dx) finite-difference gradients of ``(N, C, H, W)`` images.

    The last row of ``dy`` and the last column of ``dx`` are zero, as in the
    reference (and TensorFlow).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import image_gradients
        >>> img = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
        >>> dy, dx = image_gradients(img)
        >>> dy[0, 0, :, :]
        tensor([[4., 4., 4., 4.],
                [4., 4., 4., 4.],
                [4., 4., 4., 4.],
                [0., 0., 0., 0.]])
    """
    img = torch.as_tensor(img)
    if img.ndim != 4:
        raise RuntimeError(f"expected 4D tensor as input, got {img.ndim}D input instead")
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))
