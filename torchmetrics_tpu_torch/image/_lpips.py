"""LPIPS network in PyTorch (port of ``torchmetrics_tpu/image/_lpips.py``).

VGG16 / AlexNet / SqueezeNet-1.1 trunks and learned 1x1 ``lin`` heads over
unit-normalised feature differences. Submodules carry the flax module names
(``net.Conv_3``, ``net.fire6_expand3``, ``lin2``), so the JAX package's
converted ``.npz`` files load through
:mod:`torchmetrics_tpu_torch.utilities.convert` unchanged. The trunk convs are
plain ``conv + ReLU`` layers in the compute dtype; each head runs through
kernel B3 (:func:`torchmetrics_tpu_torch._kernels.lpips_head.lpips_head`), or,
with ``unfused=True``, as the literal oracle graph.

Weights cannot be downloaded: the network starts from seeded random weights
drawn with the flax laws, or loads converted ones from ``weights_path``.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from torchmetrics_tpu_torch._compile import CapturedForward, device_constant
from torchmetrics_tpu_torch._kernels.lanes import cat_channels, channels_last
from torchmetrics_tpu_torch._kernels.lpips_head import lpips_head
from torchmetrics_tpu_torch.image._inception import init_weights_
from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, load_variables_npz, lpips_state_dict_from_variables
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

# ImageNet scaling constants used by LPIPS (reference ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
# taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG_TAPS = (1, 3, 6, 9, 12)
_VGG_CHANNELS = (64, 128, 256, 512, 512)
_ALEX_CHANNELS = (64, 192, 384, 256, 256)
_SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# (torchvision index, input channels, squeeze, expand) of each fire module
_SQUEEZE_FIRES = ((3, 64, 16, 64), (4, 128, 16, 64), (6, 128, 32, 128), (7, 256, 32, 128),
                  (9, 256, 48, 192), (10, 384, 48, 192), (11, 384, 64, 256), (12, 512, 64, 256))


def _conv_relu(conv: nn.Conv2d, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax ``nn.Conv(dtype=...)`` + ReLU: input, kernel and bias in the compute dtype."""
    return torch.relu(F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), conv.stride, conv.padding))


class VGG16Features(nn.Module):
    """VGG16 conv trunk returning the 5 LPIPS feature taps."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        in_ch, idx = 3, 0
        for v in _VGG16_CFG:
            if v != "M":
                self.add_module(f"Conv_{idx}", nn.Conv2d(in_ch, v, 3, padding=1))
                in_ch, idx = v, idx + 1

    def forward(self, x: Tensor) -> List[Tensor]:
        taps, idx = [], 0
        for v in _VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, stride=2)
                continue
            x = _conv_relu(getattr(self, f"Conv_{idx}"), x, self.dtype)
            if idx in _VGG_TAPS:
                taps.append(x)
            idx += 1
        return taps


class AlexNetFeatures(nn.Module):
    """AlexNet conv trunk (torchvision ``alexnet().features``) returning the 5 LPIPS taps."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.Conv_1 = nn.Conv2d(64, 192, 5, padding=2)
        self.Conv_2 = nn.Conv2d(192, 384, 3, padding=1)
        self.Conv_3 = nn.Conv2d(384, 256, 3, padding=1)
        self.Conv_4 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x: Tensor) -> List[Tensor]:
        taps = []
        for i in range(5):
            if i in (1, 2):
                x = F.max_pool2d(x, 3, stride=2)
            x = _conv_relu(getattr(self, f"Conv_{i}"), x, self.dtype)
            taps.append(x)
        return taps


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet-1.1 trunk (torchvision ``squeezenet1_1().features``) returning the 7 LPIPS taps."""

    def __init__(self, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(3, 64, 3, stride=2)
        for idx, cin, squeeze, expand in _SQUEEZE_FIRES:
            self.add_module(f"fire{idx}_squeeze", nn.Conv2d(cin, squeeze, 1))
            self.add_module(f"fire{idx}_expand1", nn.Conv2d(squeeze, expand, 1))
            self.add_module(f"fire{idx}_expand3", nn.Conv2d(squeeze, expand, 3, padding=1))

    def _fire(self, x: Tensor, idx: int) -> Tensor:
        s = _conv_relu(getattr(self, f"fire{idx}_squeeze"), x, self.dtype)
        e1 = _conv_relu(getattr(self, f"fire{idx}_expand1"), s, self.dtype)
        e3 = _conv_relu(getattr(self, f"fire{idx}_expand3"), s, self.dtype)
        return cat_channels([e1, e3])

    def forward(self, x: Tensor) -> List[Tensor]:
        # torch MaxPool2d(3, 2, ceil_mode=True), the JAX package's _max_pool_ceil
        pool = lambda t: F.max_pool2d(t, 3, stride=2, ceil_mode=True)  # noqa: E731
        x = _conv_relu(self.Conv_0, x, self.dtype)
        taps = [x]  # relu1 (64)
        x = self._fire(self._fire(pool(x), 3), 4)
        taps.append(x)  # relu2 (128)
        x = self._fire(self._fire(pool(x), 6), 7)
        taps.append(x)  # relu3 (256)
        x = self._fire(pool(x), 9)
        taps.append(x)  # relu4 (384)
        for idx in (10, 11, 12):  # relu5 (384), relu6 (512), relu7 (512)
            x = self._fire(x, idx)
            taps.append(x)
        return taps


_LPIPS_TRUNKS = {"vgg": VGG16Features, "alex": AlexNetFeatures, "squeeze": SqueezeNetFeatures}
_TAP_CHANNELS = {"vgg": _VGG_CHANNELS, "alex": _ALEX_CHANNELS, "squeeze": _SQUEEZE_CHANNELS}


def _normalize_tensor(x: Tensor, eps: float = 1e-10) -> Tensor:
    norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPSNet(nn.Module):
    """Full LPIPS: trunk + per-tap ``lin`` heads, spatially averaged and summed per image pair.

    ``unfused=True`` keeps the literal oracle graph (normalise, subtract,
    square, 1x1 conv, mean as separate ops), which the kernel path is held
    against.
    """

    def __init__(self, net_type: str = "vgg", dtype: torch.dtype = torch.float32, unfused: bool = False) -> None:
        super().__init__()
        if net_type not in _LPIPS_TRUNKS:
            raise ValueError(f"Argument `net_type` must be one of 'vgg', 'alex' or 'squeeze', but got {net_type}")
        self.unfused = unfused
        self.net = _LPIPS_TRUNKS[net_type](dtype=dtype)
        for i, c in enumerate(_TAP_CHANNELS[net_type]):
            self.add_module(f"lin{i}", nn.Conv2d(c, 1, 1, bias=False))

    def forward(self, img0: Tensor, img1: Tensor) -> Tensor:
        # imgs: (N, 3, H, W) in [-1, 1], ImageNet scaling
        shift = device_constant(_SHIFT, img0.device, torch.float32).view(1, 3, 1, 1)
        scale = device_constant(_SCALE, img0.device, torch.float32).view(1, 3, 1, 1)
        n = img0.shape[0]
        # one trunk pass over the concatenated pair batch; each tap's halves are
        # channels_last views, so their (B, H, W, C) permutes need no copy
        x = channels_last(torch.cat([(img0 - shift) / scale, (img1 - shift) / scale]))
        return self.heads(self.net(x), n)

    def heads(self, feats: List[Tensor], n: int) -> Tensor:
        """``(n,)`` distances from the trunk's taps over the pair batch: pair ``i`` is rows ``i`` and ``n + i``."""
        total = 0.0
        with full_fp32():  # the head's 1x1 conv at precision "highest"
            for i, f in enumerate(feats):
                # distances accumulate in float32 whatever the trunk's dtype; the head
                # kernel reads the trunk's dtype itself, the oracle casts first
                f0, f1 = f[:n], f[n:]
                lin = getattr(self, f"lin{i}")
                if self.unfused:
                    d = (_normalize_tensor(f0.float()) - _normalize_tensor(f1.float())) ** 2
                    total = total + F.conv2d(d, lin.weight.float()).mean(dim=(1, 2, 3))
                else:
                    total = total + lpips_head(f0.permute(0, 2, 3, 1), f1.permute(0, 2, 3, 1), lin.weight)
        return total


class LPIPSExtractor(nn.Module):
    """The LPIPS network with its weights: seeded random ones, or converted ones from ``weights_path``.

    ``compute_dtype`` (default bfloat16) is the trunk convs' dtype; the heads
    stay float32. ``device``: ``cuda`` unless given (raising where there is none).
    """

    def __init__(
        self,
        net_type: str = "vgg",
        weights_path: Optional[str] = None,
        seed: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        unfused: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        if net_type not in _LPIPS_TRUNKS:
            raise ValueError(f"Argument `net_type` must be one of 'vgg', 'alex' or 'squeeze', but got {net_type}")
        device = _resolve_device(device)
        dtype = compute_dtype if compute_dtype is not None else torch.bfloat16
        net = build_on_cpu(LPIPSNet, net_type=net_type, dtype=dtype, unfused=unfused)
        if weights_path:
            net.load_state_dict(lpips_state_dict_from_variables(load_variables_npz(weights_path)))
        else:
            rank_zero_warn(
                "LPIPS network initialized with random weights (no `weights_path` given; this environment"
                " cannot download pretrained checkpoints). Scores will not match the published LPIPS metric;"
                " pass converted weights or a custom `net` callable for real use."
            )
            init_weights_(net, seed)
        self.net = net.to(device=device, memory_format=torch.channels_last).eval().requires_grad_(False)
        self.captured = CapturedForward()

    @property
    def device(self) -> torch.device:
        return self.net.lin0.weight.device

    def forward(self, img0: Tensor, img1: Tensor) -> Tensor:
        """``(N,)`` distances of ``(N, 3, H, W)`` image pairs in [-1, 1]; on the card one CUDA graph per input shape."""
        img0 = torch.as_tensor(img0, device=self.device).float()
        img1 = torch.as_tensor(img1, device=self.device).float()
        return self.captured(self._distances, img0, img1)

    def _distances(self, img0: Tensor, img1: Tensor) -> Tensor:
        with torch.no_grad():
            return self.net(img0, img1)
