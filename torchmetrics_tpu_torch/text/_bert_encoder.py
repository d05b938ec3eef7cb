"""BERT encoder (+ optional MLM head) for BERTScore and InfoLM, in PyTorch.

Port of ``torchmetrics_tpu/text/_bert_encoder.py``, op for op: post-LayerNorm
encoder blocks, erf-GELU, additive attention masking, eps 1e-12, position ids
``arange(L)`` and token types 0. Submodules carry the flax module names
(``bert.layer_3.attention.query``, ``mlm.transform_ln``), so the JAX package's
converted ``.npz`` (``tools/convert_weights.py bert``) loads through
:func:`torchmetrics_tpu_torch.utilities.convert.bert_state_dict_from_variables`.

Each block's attention core runs through kernel B4 and each residual
LayerNorm through kernel B5 (:mod:`torchmetrics_tpu_torch._kernels.attention`);
``unfused=True`` keeps the literal oracle graph: the plain attention, then
``x + out`` and a LayerNorm. The embedding LayerNorm and the MLM head's
``transform_ln`` are flax ``nn.LayerNorm`` in the JAX package too, never B5.
float32 Dense layers run in full float32 (:func:`full_fp32`), as the JAX
package asks ``precision="highest"`` of them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from torchmetrics_tpu_torch._compile import CapturedForward
from torchmetrics_tpu_torch._kernels.attention import attention, attention_plain, layernorm_residual
from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.convert import bert_state_dict_from_variables, build_on_cpu, load_variables_npz


class BertConfig:
    def __init__(
        self,
        vocab_size: int,
        hidden_size: int,
        num_layers: int,
        num_heads: int,
        intermediate_size: int,
        max_position: int = 512,
        type_vocab: int = 2,
        layer_norm_eps: float = 1e-12,
        with_mlm_head: bool = False,
    ) -> None:
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab = type_vocab
        self.layer_norm_eps = layer_norm_eps
        self.with_mlm_head = with_mlm_head


def _dense(layer: nn.Linear, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (``scale`` as ``weight``, ``bias``): fast variance, clamped at 0, float32 out."""

    def __init__(self, size: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x: Tensor) -> Tensor:
        x = x.float()
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp_min(torch.mean(x * x, dim=-1, keepdim=True) - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    def residual(self, x: Tensor, h: Tensor, unfused: bool) -> Tensor:
        """``LayerNorm(x + h)``: kernel B5, or the oracle's add and flax LayerNorm."""
        if unfused:
            return self(x + h)
        return layernorm_residual(x, h, self.weight, self.bias, eps=self.eps)


class _SelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, eps: float, dtype: torch.dtype, unfused: bool) -> None:
        super().__init__()
        self.num_heads, self.dtype, self.unfused = num_heads, dtype, unfused
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(hidden_size, hidden_size))
        self.ln = _LayerNorm(hidden_size, eps)

    def forward(self, x: Tensor, mask: Tensor) -> Tensor:
        q, k, v = (_dense(getattr(self, name), x, self.dtype) for name in ("query", "key", "value"))
        core = attention_plain if self.unfused else attention
        ctx = core(q, k, v, mask, num_heads=self.num_heads)
        return self.ln.residual(x, _dense(self.out, ctx, self.dtype), self.unfused)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype, unfused: bool) -> None:
        super().__init__()
        self.dtype, self.unfused = dtype, unfused
        self.attention = _SelfAttention(cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps, dtype, unfused)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: Tensor, mask: Tensor) -> Tensor:
        x = self.attention(x, mask)
        h = F.gelu(_dense(self.intermediate, x, self.dtype), approximate="none")  # HF "gelu" is the erf form
        return self.ln.residual(x, _dense(self.output, h, self.dtype), self.unfused)


class BertEncoder(nn.Module):
    """HF ``BertModel``-equivalent encoder returning the one hidden state asked for.

    The JAX package returns every hidden state and lets ``jit`` prune the
    ones not read; here only the selected layer's is kept (at 3,000 x 128
    tokens a float32 hidden state is 1.2 GB), and no layer past it runs.
    """

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, unfused: bool = False) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embeddings = nn.Embedding(config.max_position, config.hidden_size)
        self.token_type_embeddings = nn.Embedding(config.type_vocab, config.hidden_size)
        self.embeddings_ln = _LayerNorm(config.hidden_size, config.layer_norm_eps)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", _EncoderLayer(config, dtype, unfused))

    def forward(self, input_ids: Tensor, attention_mask: Tensor, num_layers: Optional[int] = None) -> Tensor:
        """Hidden state ``num_layers`` (0: the embeddings' output; negative counts from the end; default the last), float32."""
        depth = self.config.num_layers
        index = depth if num_layers is None else num_layers
        if not -(depth + 1) <= index <= depth:
            raise ValueError(f"`num_layers` {num_layers} is outside the encoder's {depth} layers")
        index %= depth + 1
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        # token types are all 0, so their embedding is row 0 for every token
        x = self.word_embeddings(input_ids) + self.position_embeddings(positions) + self.token_type_embeddings.weight[0]
        x = self.embeddings_ln(x).to(self.dtype)
        mask = attention_mask.to(torch.float32)
        for i in range(index):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x.float()


class BertMLMHead(nn.Module):
    """HF ``BertForMaskedLM`` prediction head (transform + decoder), logits in float32."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.transform = nn.Linear(config.hidden_size, config.hidden_size)
        self.transform_ln = _LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.decoder = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, hidden: Tensor) -> Tensor:
        h = F.gelu(_dense(self.transform, hidden, self.dtype), approximate="none")
        h = self.transform_ln(h)
        with full_fp32():
            return F.linear(h, self.decoder.weight.float(), self.decoder.bias.float())


class _BertWithHead(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, unfused: bool = False) -> None:
        super().__init__()
        self.config = config
        self.bert = BertEncoder(config, dtype, unfused)
        if config.with_mlm_head:
            self.mlm = BertMLMHead(config, dtype)


def init_bert_weights_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights with HF's BERT initializer: normal(0, 0.02) tables and kernels, zero biases, LayerNorm 1/0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Linear, nn.Embedding)):
                sub.weight.normal_(0.0, 0.02, generator=gen)
                if getattr(sub, "bias", None) is not None:
                    sub.bias.zero_()
            elif isinstance(sub, _LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
    return module


def _load(weights_path: str, compute_dtype: Optional[torch.dtype], unfused: bool, device) -> _BertWithHead:
    state, config = bert_state_dict_from_variables(load_variables_npz(weights_path))
    dtype = compute_dtype if compute_dtype is not None else torch.float32
    net = build_on_cpu(_BertWithHead, config, dtype=dtype, unfused=unfused)
    net.load_state_dict(state)
    return net.to(device=device).eval().requires_grad_(False)


class BertEncoderExtractor(nn.Module):
    """Embedding callable for :func:`bert_score`: ``(input_ids, attention_mask) -> (B, L, H)`` float32.

    ``weights_path``: a converted BERT ``.npz``. ``num_layers`` selects the
    hidden state as the reference's argument of that name does (0: the
    embeddings' output, N: the last layer; default the last).
    ``compute_dtype``: float32 (default) or bfloat16 for the Dense layers.
    ``device``: ``cuda`` unless given (raising where there is none).
    """

    def __init__(
        self,
        weights_path: str,
        num_layers: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        unfused: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        self.net = _load(weights_path, compute_dtype, unfused, _resolve_device(device))
        self.config = self.net.config
        self.num_layers = num_layers
        self.captured = CapturedForward()

    @property
    def device(self) -> torch.device:
        return self.net.bert.word_embeddings.weight.device

    def forward(self, input_ids, attention_mask) -> Tensor:
        """On the card, one CUDA graph per ``(B, L)`` and dtypes (the JAX package's ``jit``)."""
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = torch.as_tensor(attention_mask, device=self.device)
        return self.captured(self._hidden, ids, mask, statics=(self.num_layers,))

    def _hidden(self, ids: Tensor, mask: Tensor) -> Tensor:
        with torch.no_grad(), full_fp32():
            return self.net.bert(ids, mask, self.num_layers)


class BertMLMExtractor(nn.Module):
    """Vocab-logits callable for InfoLM: ``(input_ids, attention_mask) -> (B, L, vocab)`` float32.

    :meth:`logits_at` runs the head at one position only; the head is
    row-wise, so its values are those of the full logits there.
    """

    def __init__(
        self,
        weights_path: str,
        compute_dtype: Optional[torch.dtype] = None,
        unfused: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        net = _load(weights_path, compute_dtype, unfused, _resolve_device(device))
        if not net.config.with_mlm_head:
            raise ValueError(
                "This checkpoint has no MLM head; convert a BertForMaskedLM state dict with"
                " `tools/convert_weights.py bert` (the head is picked up automatically)."
            )
        self.net = net
        self.config = net.config
        self.captured = CapturedForward()

    @property
    def device(self) -> torch.device:
        return self.net.bert.word_embeddings.weight.device

    def forward(self, input_ids, attention_mask) -> Tensor:
        """On the card, one CUDA graph per ``(B, L)`` and dtypes (the JAX package's ``jit``)."""
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = torch.as_tensor(attention_mask, device=self.device)
        return self.captured(self._logits, ids, mask, statics=("all",))

    def logits_at(self, input_ids, attention_mask, index: int) -> Tensor:
        """``(B, vocab)`` logits at position ``index``: ``self(ids, mask)[:, index]`` with the head run there only.

        The position is an input of the graph, not a static: one graph per
        ``(B, L)`` serves every position.
        """
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = torch.as_tensor(attention_mask, device=self.device)
        length = ids.shape[1]
        if not -length <= index < length:
            raise IndexError(f"position {index} is outside the sequence's {length} tokens")
        # a fresh one-element tensor: the allocator aligns it alike every call, so one layout keys every position
        at = torch.full((1,), index % length, dtype=torch.int64, device=ids.device)
        return self.captured(self._logits_at, ids, mask, at, statics=("at",))

    def _logits(self, ids: Tensor, mask: Tensor) -> Tensor:
        with torch.no_grad(), full_fp32():
            return self.net.mlm(self.net.bert(ids, mask))

    def _logits_at(self, ids: Tensor, mask: Tensor, at: Tensor) -> Tensor:
        with torch.no_grad(), full_fp32():
            return self.net.mlm(self.net.bert(ids, mask).index_select(1, at)[:, 0])
