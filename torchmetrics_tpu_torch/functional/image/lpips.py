"""Functional LPIPS (port of ``torchmetrics_tpu/functional/image/lpips.py``).

One-shot form of :class:`~torchmetrics_tpu_torch.image.LearnedPerceptualImagePatchSimilarity`:
runs the perceptual network on one batch pair, where the images lie, and
reduces the distances.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import Tensor


def learned_perceptual_image_patch_similarity(
    img1: Tensor,
    img2: Tensor,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    net: Optional[Callable] = None,
) -> Tensor:
    """Learned Perceptual Image Patch Similarity between two ``(N, 3, H, W)`` image batches.

    Args:
        img1: first set of images, in ``[-1, 1]`` (``[0, 1]`` with ``normalize=True``).
        img2: second set of images, same range.
        net_type: backbone of the built-in network: ``'alex'``, ``'vgg'`` or
            ``'squeeze'``; it is built with seeded random weights on ``img1``'s device.
        reduction: ``'mean'`` or ``'sum'`` over the batch dimension.
        normalize: whether inputs are in ``[0, 1]`` (rescaled internally).
        net: optional callable ``(img1, img2) -> (N,)`` distances, overriding ``net_type``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import learned_perceptual_image_patch_similarity
        >>> gen = torch.Generator().manual_seed(123)
        >>> img1 = torch.rand((2, 3, 64, 64), generator=gen) * 2 - 1
        >>> img2 = torch.rand((2, 3, 64, 64), generator=gen) * 2 - 1
        >>> d = learned_perceptual_image_patch_similarity(img1, img2, net_type='squeeze')
        >>> bool(torch.isfinite(d))  # sign is meaningless under random head weights
        True
    """
    valid_net_type = ("vgg", "alex", "squeeze")
    img1, img2 = torch.as_tensor(img1), torch.as_tensor(img2)
    if net is None:
        if net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor

        net = LPIPSExtractor(net_type=net_type, device=img1.device)
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Argument `reduction` must be one of ('mean', 'sum'), but got {reduction}")
    if not isinstance(normalize, bool):
        raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")

    if normalize:
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    scores = torch.as_tensor(net(img1, img2)).reshape(-1)
    return scores.mean() if reduction == "mean" else scores.sum()
