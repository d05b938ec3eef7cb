"""InceptionV3 feature extractor for FID, in PyTorch (port of ``torchmetrics_tpu/image/_inception.py``).

The FID-style InceptionV3 (1008-class TF checkpoint layout): conv stacks and
Inception blocks with inference BatchNorm, the ``64/192/768/2048`` pooled
taps and ``logits_unbiased``. Submodules carry the flax module names
(``BasicConv2d_0``, ``InceptionA_1/BasicConv2d_3``, ``Conv_0``,
``BatchNorm_0``, ``fc``), so the JAX package's converted ``.npz`` files load
through :mod:`torchmetrics_tpu_torch.utilities.convert` unchanged.

Tensors are NCHW in shape and channels_last in memory from the input on, so
every conv's ``(N*H*W, C)`` view is the memory itself. The layout is set and
the branches are concatenated through :mod:`._kernels.lanes`, which keeps it
on a vmapped lane too (a stream pool's step), where the convs fold the lanes
into ``N``. A BN-folded trunk
(``fuse_bn=True``) runs every ``BasicConv2d`` through
:func:`torchmetrics_tpu_torch._kernels.conv_epilogue.conv_bias_act`: its 40
pointwise convs are kernel B2a alone and its 54 spatial convs are the
library conv followed by kernel B2b. The unfused trunk is the literal
``conv -> BatchNorm -> ReLU`` graph in PyTorch.

Weights: nothing can be downloaded, so the trunk starts from seeded random
weights drawn with the flax laws (``lecun_normal`` kernels, zero biases,
identity BatchNorm), or loads a converted checkpoint from ``weights_path``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from torchmetrics_tpu_torch._compile import CapturedForward
from torchmetrics_tpu_torch._kernels.conv_epilogue import conv_bias_act
from torchmetrics_tpu_torch._kernels.lanes import cat_channels, channels_last
from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, inception_state_dict_from_variables, load_variables_npz
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

FEATURES = ("64", "192", "768", "2048", "logits_unbiased")
_BN_EPS = 1e-3
IntPair = Union[int, Tuple[int, int]]


class _BatchNorm(nn.Module):
    """Inference BatchNorm (flax ``use_running_average=True``, eps 1e-3), computed in float32.

    Like flax, ``(y - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
    rounded once to the input's dtype.
    """

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, y: Tensor) -> Tensor:
        mul = torch.rsqrt(self.running_var.float() + _BN_EPS) * self.weight.float()
        out = (y.float() - self.running_mean.float()[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return out.to(y.dtype)


class BasicConv2d(nn.Module):
    """``conv -> BatchNorm -> ReLU``; with ``fuse_bn`` the BN is folded into the conv and the unit is one
    :func:`conv_bias_act`. Inputs and weights are cast to ``dtype`` per call; parameters keep theirs."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: IntPair,
        stride: IntPair = 1,
        padding: IntPair = 0,
        dtype: torch.dtype = torch.float32,
        fuse_bn: bool = False,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.fuse_bn = fuse_bn
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=fuse_bn)
        if not fuse_bn:
            self.BatchNorm_0 = _BatchNorm(out_channels)

    def forward(self, x: Tensor) -> Tensor:
        conv = self.Conv_0
        x, weight = x.to(self.dtype), conv.weight.to(self.dtype)
        if self.fuse_bn:
            return conv_bias_act(x, weight, conv.bias.to(self.dtype), conv.stride, conv.padding)
        return torch.relu(self.BatchNorm_0(F.conv2d(x, weight, None, conv.stride, conv.padding)))


def _avg_pool(x: Tensor) -> Tensor:
    # flax avg_pool(count_include_pad=False), 3x3, stride 1, padding 1
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int, dtype: torch.dtype, fuse_bn: bool) -> None:
        super().__init__()
        kw = {"dtype": dtype, "fuse_bn": fuse_bn}
        self.BasicConv2d_0 = BasicConv2d(in_channels, 64, 1, **kw)
        self.BasicConv2d_1 = BasicConv2d(in_channels, 48, 1, **kw)
        self.BasicConv2d_2 = BasicConv2d(48, 64, 5, padding=2, **kw)
        self.BasicConv2d_3 = BasicConv2d(in_channels, 64, 1, **kw)
        self.BasicConv2d_4 = BasicConv2d(64, 96, 3, padding=1, **kw)
        self.BasicConv2d_5 = BasicConv2d(96, 96, 3, padding=1, **kw)
        self.BasicConv2d_6 = BasicConv2d(in_channels, pool_features, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.BasicConv2d_0(x)
        b5 = self.BasicConv2d_2(self.BasicConv2d_1(x))
        b3 = self.BasicConv2d_5(self.BasicConv2d_4(self.BasicConv2d_3(x)))
        bp = self.BasicConv2d_6(_avg_pool(x))
        return cat_channels([b1, b5, b3, bp])


class InceptionB(nn.Module):
    def __init__(self, in_channels: int, dtype: torch.dtype, fuse_bn: bool) -> None:
        super().__init__()
        kw = {"dtype": dtype, "fuse_bn": fuse_bn}
        self.BasicConv2d_0 = BasicConv2d(in_channels, 384, 3, stride=2, **kw)
        self.BasicConv2d_1 = BasicConv2d(in_channels, 64, 1, **kw)
        self.BasicConv2d_2 = BasicConv2d(64, 96, 3, padding=1, **kw)
        self.BasicConv2d_3 = BasicConv2d(96, 96, 3, stride=2, **kw)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.BasicConv2d_0(x)
        bd = self.BasicConv2d_3(self.BasicConv2d_2(self.BasicConv2d_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return cat_channels([b3, bd, bp])


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int, dtype: torch.dtype, fuse_bn: bool) -> None:
        super().__init__()
        kw = {"dtype": dtype, "fuse_bn": fuse_bn}
        c7 = channels_7x7
        self.BasicConv2d_0 = BasicConv2d(in_channels, 192, 1, **kw)
        self.BasicConv2d_1 = BasicConv2d(in_channels, c7, 1, **kw)
        self.BasicConv2d_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.BasicConv2d_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.BasicConv2d_4 = BasicConv2d(in_channels, c7, 1, **kw)
        self.BasicConv2d_5 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.BasicConv2d_6 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.BasicConv2d_7 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.BasicConv2d_8 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), **kw)
        self.BasicConv2d_9 = BasicConv2d(in_channels, 192, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.BasicConv2d_0(x)
        b7 = self.BasicConv2d_3(self.BasicConv2d_2(self.BasicConv2d_1(x)))
        bd = self.BasicConv2d_4(x)
        for unit in (self.BasicConv2d_5, self.BasicConv2d_6, self.BasicConv2d_7, self.BasicConv2d_8):
            bd = unit(bd)
        bp = self.BasicConv2d_9(_avg_pool(x))
        return cat_channels([b1, b7, bd, bp])


class InceptionD(nn.Module):
    def __init__(self, in_channels: int, dtype: torch.dtype, fuse_bn: bool) -> None:
        super().__init__()
        kw = {"dtype": dtype, "fuse_bn": fuse_bn}
        self.BasicConv2d_0 = BasicConv2d(in_channels, 192, 1, **kw)
        self.BasicConv2d_1 = BasicConv2d(192, 320, 3, stride=2, **kw)
        self.BasicConv2d_2 = BasicConv2d(in_channels, 192, 1, **kw)
        self.BasicConv2d_3 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), **kw)
        self.BasicConv2d_4 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), **kw)
        self.BasicConv2d_5 = BasicConv2d(192, 192, 3, stride=2, **kw)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.BasicConv2d_1(self.BasicConv2d_0(x))
        b7 = self.BasicConv2d_2(x)
        for unit in (self.BasicConv2d_3, self.BasicConv2d_4, self.BasicConv2d_5):
            b7 = unit(b7)
        bp = F.max_pool2d(x, 3, stride=2)
        return cat_channels([b3, b7, bp])


class InceptionE(nn.Module):
    def __init__(self, in_channels: int, pool_type: str, dtype: torch.dtype, fuse_bn: bool) -> None:
        super().__init__()
        kw = {"dtype": dtype, "fuse_bn": fuse_bn}
        self.pool_type = pool_type  # the FID variant max-pools in its last block
        self.BasicConv2d_0 = BasicConv2d(in_channels, 320, 1, **kw)
        self.BasicConv2d_1 = BasicConv2d(in_channels, 384, 1, **kw)
        self.BasicConv2d_2 = BasicConv2d(384, 384, (1, 3), padding=(0, 1), **kw)
        self.BasicConv2d_3 = BasicConv2d(384, 384, (3, 1), padding=(1, 0), **kw)
        self.BasicConv2d_4 = BasicConv2d(in_channels, 448, 1, **kw)
        self.BasicConv2d_5 = BasicConv2d(448, 384, 3, padding=1, **kw)
        self.BasicConv2d_6 = BasicConv2d(384, 384, (1, 3), padding=(0, 1), **kw)
        self.BasicConv2d_7 = BasicConv2d(384, 384, (3, 1), padding=(1, 0), **kw)
        self.BasicConv2d_8 = BasicConv2d(in_channels, 192, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.BasicConv2d_0(x)
        b3 = self.BasicConv2d_1(x)
        b3 = cat_channels([self.BasicConv2d_2(b3), self.BasicConv2d_3(b3)])
        bd = self.BasicConv2d_5(self.BasicConv2d_4(x))
        bd = cat_channels([self.BasicConv2d_6(bd), self.BasicConv2d_7(bd)])
        bp = _avg_pool(x) if self.pool_type == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        bp = self.BasicConv2d_8(bp)
        return cat_channels([b1, b3, bd, bp])


class InceptionV3(nn.Module):
    """FID-style InceptionV3. ``forward(x, feature)`` returns one tap and stops there; ``feature=None`` gives all.

    ``x``: ``(N, 3, H, W)`` in [-1, 1] (TF preprocessing), best channels_last.
    Taps are float32 means over H and W; ``logits_unbiased`` is the bias-free
    1008-way head on the 2048-d tap, in full float32.
    """

    def __init__(self, num_classes: int = 1008, dtype: torch.dtype = torch.float32, fuse_bn: bool = False) -> None:
        super().__init__()
        kw = {"dtype": dtype, "fuse_bn": fuse_bn}
        self.BasicConv2d_0 = BasicConv2d(3, 32, 3, stride=2, **kw)
        self.BasicConv2d_1 = BasicConv2d(32, 32, 3, **kw)
        self.BasicConv2d_2 = BasicConv2d(32, 64, 3, padding=1, **kw)
        self.BasicConv2d_3 = BasicConv2d(64, 80, 1, **kw)
        self.BasicConv2d_4 = BasicConv2d(80, 192, 3, **kw)
        self.InceptionA_0 = InceptionA(192, 32, **kw)
        self.InceptionA_1 = InceptionA(256, 64, **kw)
        self.InceptionA_2 = InceptionA(288, 64, **kw)
        self.InceptionB_0 = InceptionB(288, **kw)
        self.InceptionC_0 = InceptionC(768, 128, **kw)
        self.InceptionC_1 = InceptionC(768, 160, **kw)
        self.InceptionC_2 = InceptionC(768, 160, **kw)
        self.InceptionC_3 = InceptionC(768, 192, **kw)
        self.InceptionD_0 = InceptionD(768, **kw)
        self.InceptionE_0 = InceptionE(1280, "avg", **kw)
        self.InceptionE_1 = InceptionE(2048, "max", **kw)
        self.fc = nn.Linear(2048, num_classes, bias=False)

    def _stages(self):
        pool = lambda x: F.max_pool2d(x, 3, stride=2)  # noqa: E731
        yield "64", (self.BasicConv2d_0, self.BasicConv2d_1, self.BasicConv2d_2, pool)
        yield "192", (self.BasicConv2d_3, self.BasicConv2d_4, pool)
        yield "768", (
            self.InceptionA_0, self.InceptionA_1, self.InceptionA_2, self.InceptionB_0,
            self.InceptionC_0, self.InceptionC_1, self.InceptionC_2, self.InceptionC_3,
        )
        yield "2048", (self.InceptionD_0, self.InceptionE_0, self.InceptionE_1)

    def forward(self, x: Tensor, feature: Optional[str] = None) -> Union[Tensor, Dict[str, Tensor]]:
        if feature is not None and str(feature) not in FEATURES:
            raise ValueError(f"`feature` must be one of {FEATURES}, got {feature!r}")
        out: Dict[str, Tensor] = {}
        for tap, layers in self._stages():
            for layer in layers:
                x = layer(x)
            out[tap] = x.float().mean(dim=(2, 3))
            if feature is not None and str(feature) == tap:
                return out[tap]
        with full_fp32():
            out["logits_unbiased"] = F.linear(out["2048"], self.fc.weight.float())
        return out if feature is None else out["logits_unbiased"]


def init_weights_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights with the flax laws: ``lecun_normal`` kernels, zero biases, identity BatchNorm."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Conv2d, nn.Linear)):
                fan_in = sub.weight[0].numel()
                # flax lecun_normal: truncated normal at +-2 std, rescaled to variance 1 / fan_in
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(sub.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, _BatchNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
                sub.running_mean.zero_()
                sub.running_var.fill_(1.0)
    return module


def fold_batchnorm(state: Dict[str, Tensor], epsilon: float = _BN_EPS) -> Dict[str, Tensor]:
    """Fold inference BatchNorm into each preceding conv: the unfused trunk's ``state_dict`` -> the fused one's.

    ``conv(x, W)`` then ``(y - mean) * scale / sqrt(var + eps) + beta`` is
    ``conv(x, W * m) + (beta - mean * m)`` with ``m = scale / sqrt(var + eps)``,
    per output channel (the JAX package's ``fold_batchnorm``).
    """
    out: Dict[str, Tensor] = {}
    folded = set()
    for key in state:
        if not key.endswith("BatchNorm_0.weight"):
            continue
        unit = key[: -len("BatchNorm_0.weight")]
        bn = {leaf: state[f"{unit}BatchNorm_0.{leaf}"] for leaf in ("weight", "bias", "running_mean", "running_var")}
        mult = bn["weight"] / torch.sqrt(bn["running_var"] + epsilon)
        out[f"{unit}Conv_0.weight"] = state[f"{unit}Conv_0.weight"] * mult[:, None, None, None]
        out[f"{unit}Conv_0.bias"] = bn["bias"] - bn["running_mean"] * mult
        folded.update([f"{unit}Conv_0.weight", *(f"{unit}BatchNorm_0.{leaf}" for leaf in bn)])
    out.update({key: value for key, value in state.items() if key not in folded})
    return out


def _resize_bilinear_tf1(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """TF1.x ``resize_bilinear(align_corners=False)`` for NCHW batches.

    The legacy resize torch-fidelity replicates for FID: source coordinate
    ``dst * (in / out)`` with no half-pixel offset, so deliberately not
    ``F.interpolate``, whose half-pixel sampling gives other 2048-d features.
    """
    n, c, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x
    ys = torch.arange(out_h, dtype=torch.float32, device=x.device) * (h / out_h)
    xs = torch.arange(out_w, dtype=torch.float32, device=x.device) * (w / out_w)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (ys - y0)[None, None, :, None]
    fx = (xs - x0)[None, None, None, :]
    rows0, rows1 = x.index_select(2, y0), x.index_select(2, y1)
    r00, r01 = rows0.index_select(3, x0), rows0.index_select(3, x1)
    r10, r11 = rows1.index_select(3, x0), rows1.index_select(3, x1)
    top = r00 + (r01 - r00) * fx
    bottom = r10 + (r11 - r10) * fx
    return top + (bottom - top) * fy


class InceptionFeatureExtractor(nn.Module):
    """Resize + TF preprocessing + InceptionV3 forward, returning one float32 tap per image.

    ``feature``: ``64 / 192 / 768 / 2048 / 'logits_unbiased'``. ``weights_path``:
    a converted ``.npz`` (the JAX package's layout); without it the trunk is
    seeded random and a warning says so. ``compute_dtype`` (default
    bfloat16): the convs' dtype; parameters and taps stay float32.
    ``fuse_bn`` (default True) folds BatchNorm into the convs and runs them
    through the kernels; ``False`` keeps the literal conv+BN graph.
    ``weights_dtype`` stores the weights in that dtype. ``device``: where the
    trunk lives, ``cuda`` unless given (raising where there is none).
    """

    def __init__(
        self,
        feature: Union[int, str] = "2048",
        weights_path: Optional[str] = None,
        seed: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
        fuse_bn: bool = True,
        weights_dtype: Optional[torch.dtype] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        self.feature = str(feature)
        if self.feature not in FEATURES:
            raise ValueError(f"`feature` must be one of {FEATURES}, got {feature!r}")
        device = _resolve_device(device)
        dtype = compute_dtype if compute_dtype is not None else torch.bfloat16
        # checkpoints and the seeded init are in the unfused conv+BN layout
        unfused = build_on_cpu(InceptionV3, dtype=dtype, fuse_bn=False)
        if weights_path:
            state = inception_state_dict_from_variables(load_variables_npz(weights_path))
            if not any(key.endswith("running_mean") for key in state):
                # a params-only checkpoint: BatchNorm keeps flax's initial statistics
                for key, value in unfused.state_dict().items():
                    if key.endswith(("running_mean", "running_var")):
                        state[key] = torch.full_like(value, 0.0 if key.endswith("mean") else 1.0)
            unfused.load_state_dict(state)
        else:
            init_weights_(unfused, seed)
            rank_zero_warn(
                "InceptionV3 initialized with random weights (no `weights_path` given and this environment"
                " cannot download pretrained checkpoints). Feature statistics will be meaningless for real"
                " FID comparisons; pass a converted checkpoint or a custom feature extractor callable."
            )
        if fuse_bn:
            net = build_on_cpu(InceptionV3, dtype=dtype, fuse_bn=True)
            net.load_state_dict(fold_batchnorm(unfused.state_dict()))
        else:
            net = unfused
        if weights_dtype is not None:
            net = net.to(weights_dtype)
        self.net = net.to(device=device, memory_format=torch.channels_last).eval().requires_grad_(False)
        self.captured = CapturedForward()

    @property
    def device(self) -> torch.device:
        return self.net.fc.weight.device

    def forward(self, imgs: Tensor) -> Tensor:
        """``imgs``: ``(N, 3, H, W)`` uint8 in [0, 255] or float in [0, 1]; returns ``(N, d)`` float32.

        On the card, one CUDA graph per input shape and dtype (the JAX package's ``jit``).
        """
        imgs = torch.as_tensor(imgs, device=self.device)
        return self.captured(self._features, imgs, statics=(self.feature,))

    def _features(self, imgs: Tensor) -> Tensor:
        with torch.no_grad():
            # torch-fidelity's preprocessing: floats in [0, 1] take the byte cast
            # (floor to 0..255), then the TF1.x resize, then (x - 128) / 128
            if imgs.dtype == torch.uint8:
                x = imgs.float()
            else:
                x = torch.floor(torch.clamp(imgs.float(), 0.0, 1.0) * 255.0)
            x = (_resize_bilinear_tf1(x, 299, 299) - 128.0) / 128.0
            x = channels_last(x)
            with full_fp32():
                return self.net(x, self.feature).float()
