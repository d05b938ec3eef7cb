"""Image window helpers (port of ``torchmetrics_tpu/functional/image/helper.py``).

Gaussian and uniform windows run as depthwise convolutions (``groups=C``)
with the whole 2-D or 3-D window, the outer product of the 1-D ones, as the
JAX package runs them: two 1-D passes would sum in another order. Every
window sum runs inside :func:`full_fp32`, the counterpart of the JAX
package's ``Precision.HIGHEST``: cuDNN would otherwise take a float32
convolution in TF32. Pads follow ``numpy.pad``'s modes for any width,
through an index gather (``F.pad`` has no ``symmetric`` mode and refuses a
``reflect`` pad as wide as the side).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import full_fp32


def _gaussian_kernel_1d(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32) -> Tensor:
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1, dtype=dtype)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return gauss / gauss.sum()


def _uniform_kernel_1d(kernel_size: int, dtype: torch.dtype = torch.float32) -> Tensor:
    return torch.full((kernel_size,), 1.0 / kernel_size, dtype=dtype)


def _depthwise_conv(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise valid convolution of ``(N, C, *spatial)`` with one 2-D or 3-D window for every channel.

    Every (image, channel) plane goes in as a channel of one image: the
    libraries' depthwise kernels vectorise across channels (on a CPU, a batch
    of one-channel images runs ~10x slower than the same planes as channels).
    """
    n, c = x.shape[:2]
    k = kernel.to(device=x.device, dtype=x.dtype).expand(n * c, 1, *kernel.shape)
    conv = F.conv2d if kernel.ndim == 2 else F.conv3d
    with full_fp32():
        out = conv(x.reshape(1, n * c, *x.shape[2:]), k, groups=n * c)
    return out.reshape(n, c, *out.shape[2:])


def _depthwise_conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise valid conv. ``x``: (N, C, H, W); ``kernel``: (kh, kw)."""
    return _depthwise_conv(x, kernel)


def _depthwise_conv3d(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise valid 3D conv. ``x``: (N, C, D, H, W); ``kernel``: (kd, kh, kw)."""
    return _depthwise_conv(x, kernel)


def _gaussian_filter2d(x: Tensor, kernel_size: Sequence[int], sigma: Sequence[float]) -> Tensor:
    kh = _gaussian_kernel_1d(kernel_size[0], sigma[0])
    kw = _gaussian_kernel_1d(kernel_size[1], sigma[1])
    return _depthwise_conv2d(x, torch.outer(kh, kw))


def _uniform_filter2d(x: Tensor, kernel_size: Sequence[int]) -> Tensor:
    kh = _uniform_kernel_1d(kernel_size[0])
    kw = _uniform_kernel_1d(kernel_size[1])
    return _depthwise_conv2d(x, torch.outer(kh, kw))


def _pad_index(n: int, lead: int, trail: int, mode: str, device: torch.device) -> Tensor:
    """Source index of each position of a side of ``n`` padded by ``lead``/``trail``, as ``numpy.pad`` fills it."""
    i = torch.arange(-lead, n + trail, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    if mode == "symmetric":  # the edge sample repeated: ... b a | a b c | c b ...
        m = torch.remainder(i, 2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m)
    if mode == "reflect":  # mirrored about the edge sample: ... c b | a b c | b a ...
        m = torch.remainder(i, 2 * (n - 1))
        return torch.where(m < n, m, 2 * (n - 1) - m)
    raise ValueError(f"Unsupported pad mode {mode!r}")


def _pad(x: Tensor, pads: Sequence[Tuple[int, int]], mode: str) -> Tensor:
    """``numpy.pad`` of the trailing ``len(pads)`` dims of ``x``; ``mode``: constant (zeros), edge, symmetric or reflect."""
    first = x.ndim - len(pads)
    if mode == "constant":
        flat = [p for lead_trail in reversed(pads) for p in lead_trail]
        return F.pad(x, flat)
    for dim, (lead, trail) in enumerate(pads, start=first):
        if lead or trail:
            x = x.index_select(dim, _pad_index(x.shape[dim], lead, trail, mode, x.device))
    return x


def _uniform_filter2d_same(x: Tensor, window_size: int, mode: str = "symmetric") -> Tensor:
    """Same-size uniform (mean) filter with the reference's padding protocol.

    Pads ``ceil((ws-1)/2)`` on the leading edge and ``floor((ws-1)/2)`` on the
    trailing edge of both spatial dims, then runs a valid mean conv: the
    output keeps the input's spatial shape. ``mode='symmetric'`` is the
    scipy-style edge-inclusive reflection; ``mode='constant'`` the zero pad of
    SCC's variance windows.
    """
    lead = (window_size - 1) - (window_size - 1) // 2
    trail = (window_size - 1) // 2
    x = _pad(x, ((lead, trail), (lead, trail)), mode)
    k = torch.full((window_size, window_size), 1.0 / window_size**2, dtype=x.dtype)
    return _depthwise_conv2d(x, k)


def _reflection_pad2d(x: Tensor, pad: int) -> Tensor:
    return _pad(x, ((pad, pad), (pad, pad)), "reflect")


def _check_image_pair(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(torch.float32)
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected `preds` and `target` to have the same shape, got {preds.shape} and {target.shape}"
        )
    return preds, target
