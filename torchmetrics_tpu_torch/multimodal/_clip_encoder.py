"""CLIP's vision and text towers for CLIPScore and CLIP-IQA, in PyTorch (port of
``torchmetrics_tpu/multimodal/_clip_encoder.py``).

Op for op as the JAX package: pre-LayerNorm blocks (flax's LayerNorm, eps
1e-5), quick-GELU, attention as a plain softmax (no kernel: the JAX package's
is plain ``jnp`` too), bias-free projections. The vision tower prepends the
class token, adds learned positions, then ``pre_ln``, the blocks and
``post_ln`` on the class token. The text tower adds a causal and a padding
bias of -1e9 in float32 (not -inf: a fully padded row behaves as in JAX) and
pools at ``argmax(input_ids)`` when ``eos_token_id == 2`` (every OpenAI
config: HF's legacy branch), at the first EOS otherwise.

Submodules carry the flax module names (``vision.layer_3.attn.q``), so the
JAX package's converted ``.npz`` (``tools/convert_weights.py clip``) loads
through :func:`torchmetrics_tpu_torch.utilities.convert.clip_state_dict_from_variables`.
float32 runs in full float32 (:func:`full_fp32`, the counterpart of
``precision="highest"``); ``compute_dtype=torch.bfloat16`` runs the patch
embedding and the Dense layers in bf16 and rounds where flax rounds (after
each product, each bias add, each softmax step), the residual stream and
LayerNorms staying float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch._compile import CapturedForward, device_constant
from torchmetrics_tpu_torch.functional.image.d_s import _resize_bilinear
from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.text._bert_encoder import _LayerNorm
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.convert import build_on_cpu, clip_state_dict_from_variables, load_variables_npz

# CLIPProcessor normalization constants
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_BIAS = -1e9  # the text tower's masked logit, float32


class ClipConfig:
    def __init__(
        self,
        vocab_size: int,
        text_hidden: int,
        text_layers: int,
        text_heads: int,
        text_intermediate: int,
        max_position: int,
        vision_hidden: int,
        vision_layers: int,
        vision_heads: int,
        vision_intermediate: int,
        image_size: int,
        patch_size: int,
        projection_dim: int,
        eos_token_id: int = 2,
        layer_norm_eps: float = 1e-5,
    ) -> None:
        self.vocab_size = vocab_size
        self.text_hidden = text_hidden
        self.text_layers = text_layers
        self.text_heads = text_heads
        self.text_intermediate = text_intermediate
        self.max_position = max_position
        self.vision_hidden = vision_hidden
        self.vision_layers = vision_layers
        self.vision_heads = vision_heads
        self.vision_intermediate = vision_intermediate
        self.image_size = image_size
        self.patch_size = patch_size
        self.projection_dim = projection_dim
        self.eos_token_id = eos_token_id
        self.layer_norm_eps = layer_norm_eps


CONFIG_KEYS = (
    "vocab_size", "text_hidden", "text_layers", "text_heads", "text_intermediate", "max_position",
    "vision_hidden", "vision_layers", "vision_heads", "vision_intermediate", "image_size", "patch_size",
    "projection_dim", "eos_token_id",
)


def _dense(layer: nn.Linear, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax ``nn.Dense(dtype=...)``: the product in ``dtype`` (rounded), then the bias added in ``dtype``."""
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).T)
    return y + layer.bias.to(dtype) if layer.bias is not None else y


def _softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` step by step, each step rounded to ``x``'s dtype (the sum accumulated in float32)."""
    u = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return u / torch.sum(u, dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)


class _ClipAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        for name in ("q", "k", "v", "out"):
            self.add_module(name, nn.Linear(hidden, hidden))

    def forward(self, x: Tensor, bias: Optional[Tensor]) -> Tensor:
        b, length, _ = x.shape
        head_dim = self.hidden // self.heads

        def split(t: Tensor) -> Tensor:
            return t.reshape(b, length, self.heads, head_dim).transpose(1, 2)

        q, k, v = (split(_dense(getattr(self, name), x, self.dtype)) for name in ("q", "k", "v"))
        scores = torch.matmul(q, k.transpose(-1, -2))
        scores = scores / torch.sqrt(torch.tensor(float(head_dim), dtype=scores.dtype))
        if bias is not None:
            scores = scores + bias.to(scores.dtype)
        ctx = torch.matmul(_softmax(scores), v)
        ctx = ctx.transpose(1, 2).reshape(b, length, self.hidden)
        return _dense(self.out, ctx, self.dtype)


class _ClipLayer(nn.Module):
    """Pre-LN transformer block with quick-GELU (HF ``CLIPEncoderLayer``)."""

    def __init__(self, hidden: int, heads: int, intermediate: int, eps: float, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.ln1 = _LayerNorm(hidden, eps)
        self.attn = _ClipAttention(hidden, heads, dtype)
        self.ln2 = _LayerNorm(hidden, eps)
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x: Tensor, bias: Optional[Tensor]) -> Tensor:
        x = x + self.attn(self.ln1(x), bias)
        h = _dense(self.fc1, self.ln2(x), self.dtype)
        h = h * torch.sigmoid(1.702 * h)  # quick-GELU
        return x + _dense(self.fc2, h, self.dtype)


class ClipVisionTower(nn.Module):
    def __init__(self, cfg: ClipConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.patch_embedding = nn.Conv2d(3, cfg.vision_hidden, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.vision_hidden))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, cfg.vision_hidden)
        self.pre_ln = _LayerNorm(cfg.vision_hidden, cfg.layer_norm_eps)
        for i in range(cfg.vision_layers):
            self.add_module(f"layer_{i}", _ClipLayer(cfg.vision_hidden, cfg.vision_heads, cfg.vision_intermediate,
                                                     cfg.layer_norm_eps, dtype))
        self.post_ln = _LayerNorm(cfg.vision_hidden, cfg.layer_norm_eps)

    def forward(self, pixels: Tensor) -> Tensor:
        """``pixels``: ``(N, 3, H, W)``, normalised. Returns the pooled ``(N, hidden)`` float32."""
        w = self.patch_embedding.weight.to(self.dtype)
        patches = torch.nn.functional.conv2d(pixels.to(self.dtype), w, stride=self.cfg.patch_size)
        patches = patches.flatten(2).transpose(1, 2)  # (N, gh * gw, hidden), rows then columns, as flax's NHWC
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.weight[: x.shape[1]]
        x = self.pre_ln(x)
        for i in range(self.cfg.vision_layers):
            x = getattr(self, f"layer_{i}")(x, None)
        return self.post_ln(x[:, 0])


class ClipTextTower(nn.Module):
    def __init__(self, cfg: ClipConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_hidden)
        self.position_embedding = nn.Embedding(cfg.max_position, cfg.text_hidden)
        for i in range(cfg.text_layers):
            self.add_module(f"layer_{i}", _ClipLayer(cfg.text_hidden, cfg.text_heads, cfg.text_intermediate,
                                                     cfg.layer_norm_eps, dtype))
        self.final_ln = _LayerNorm(cfg.text_hidden, cfg.layer_norm_eps)

    def forward(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        """Features ``(B, hidden)`` float32 at the pooling position (see the module's docstring)."""
        length = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding.weight[:length]
        causal = torch.triu(torch.full((length, length), _BIAS, dtype=torch.float32, device=x.device), diagonal=1)
        pad = (1.0 - attention_mask[:, None, None, :].to(torch.float32)) * _BIAS
        bias = causal[None, None] + pad
        for i in range(self.cfg.text_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        x = self.final_ln(x)
        if self.cfg.eos_token_id == 2:
            # HF's legacy branch (every OpenAI CLIP config): the EOS id 49407 is the vocabulary's largest
            eos_idx = torch.argmax(input_ids, dim=1)
        else:
            is_eos = (input_ids == self.cfg.eos_token_id).to(torch.int64)
            eos_idx = torch.sum(torch.cumsum(is_eos, dim=1) == 0, dim=1).clamp(max=length - 1)
        return x[torch.arange(x.shape[0], device=x.device), eos_idx]


class _ClipModel(nn.Module):
    def __init__(self, config: ClipConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.config = config
        self.vision = ClipVisionTower(config, dtype)
        self.text = ClipTextTower(config, dtype)
        self.visual_projection = nn.Linear(config.vision_hidden, config.projection_dim, bias=False)
        self.text_projection = nn.Linear(config.text_hidden, config.projection_dim, bias=False)

    def image_features(self, pixels: Tensor) -> Tensor:
        return self.visual_projection(self.vision(pixels).float())

    def text_features(self, input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        return self.text_projection(self.text(input_ids, attention_mask).float())


def init_clip_weights_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in HF CLIP's spirit: normal(0, 0.02) kernels and tables, zero biases, LayerNorm 1/0.

    Drawn on the module's device, from a generator seeded there.
    """
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Linear, nn.Embedding, nn.Conv2d)):
                sub.weight.normal_(0.0, 0.02, generator=gen)
                if getattr(sub, "bias", None) is not None:
                    sub.bias.zero_()
            elif isinstance(sub, _LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
            elif isinstance(sub, ClipVisionTower):
                sub.class_embedding.normal_(0.0, 0.02, generator=gen)
    return module


class ClipExtractor(nn.Module):
    """A converted CLIP checkpoint behind the metrics' encoder contract, on ``device`` (``cuda`` unless given).

    ``tokenizer``: a callable ``(list_of_str) -> {"input_ids", "attention_mask"}``
    matching the checkpoint; :meth:`get_text_features` also takes such a
    dict. :meth:`get_image_features` takes float ``(N, 3, H, W)`` in [0, 1]
    or uint8 in [0, 255], resizes it to the checkpoint's size as
    ``jax.image.resize(method="bilinear")`` does (antialiased when it
    shrinks) and applies CLIP's mean and std.
    """

    def __init__(
        self,
        weights_path: str,
        tokenizer: Optional[Callable] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        state, config = clip_state_dict_from_variables(load_variables_npz(weights_path))
        self.config = config
        self.tokenizer = tokenizer
        dtype = compute_dtype if compute_dtype is not None else torch.float32
        net = build_on_cpu(_ClipModel, config, dtype=dtype)
        net.load_state_dict(state)
        self.net = net.to(device=_resolve_device(device)).eval().requires_grad_(False)
        self.captured = CapturedForward()

    @property
    def device(self) -> torch.device:
        return self.net.visual_projection.weight.device

    def get_image_features(self, images: Any) -> Tensor:
        """On the card, one CUDA graph per input shape and dtype (the JAX package's ``jit`` of the image tower)."""
        return self.captured(self._image_features, torch.as_tensor(images, device=self.device), statics=("image",))

    def _image_features(self, imgs: Tensor) -> Tensor:
        size = self.config.image_size
        with torch.no_grad(), full_fp32():
            imgs = imgs.to(torch.float32) / 255.0 if imgs.dtype == torch.uint8 else imgs.to(torch.float32)
            if tuple(imgs.shape[-2:]) != (size, size):
                imgs = _resize_bilinear(imgs, (size, size))
            mean = device_constant(_CLIP_MEAN, imgs.device, torch.float32).reshape(1, 3, 1, 1)
            std = device_constant(_CLIP_STD, imgs.device, torch.float32).reshape(1, 3, 1, 1)
            return self.net.image_features((imgs - mean) / std)

    def get_text_features(self, text: Any) -> Tensor:
        """Tokenized on the host; on the card the tower is one CUDA graph per ``(B, L)`` (the JAX package's ``jit``)."""
        if isinstance(text, dict):
            enc = text
        else:
            if self.tokenizer is None:
                raise ValueError(
                    "This CLIP runs on converted weights, whose token ids only make sense with the"
                    " checkpoint's tokenizer. Pass `tokenizer=` to ClipExtractor or call with a"
                    " pre-tokenized {'input_ids', 'attention_mask'} dict."
                )
            enc = self.tokenizer(list(text) if not isinstance(text, str) else [text])
        # never index past the position table (CLIP: 77); a row that loses its EOS to the cut gets it back
        width = self.config.max_position
        ids, mask = (enc[k] if isinstance(enc[k], Tensor) else device_constant(np.asarray(enc[k]), self.device)
                     for k in ("input_ids", "attention_mask"))
        ids, mask = ids.to(device=self.device, dtype=torch.int64), mask.to(self.device)
        if ids.shape[1] > width:
            ids, mask = ids[:, :width].clone(), mask[:, :width]
            missing = ~(ids == self.config.eos_token_id).any(dim=1)
            ids[:, -1] = torch.where(missing, self.config.eos_token_id, ids[:, -1])
        return self.captured(self._text_features, ids, mask, statics=("text",))

    def _text_features(self, ids: Tensor, mask: Tensor) -> Tensor:
        with torch.no_grad(), full_fp32():
            return self.net.text_features(ids, mask)
