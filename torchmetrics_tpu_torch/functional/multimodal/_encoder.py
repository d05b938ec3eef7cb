"""The default CLIP-style dual encoder, used when no checkpoint is given (port of
``torchmetrics_tpu/functional/multimodal/_encoder.py``).

A fixed random-projection model with the JAX package's draws: images are
standardised, average-pooled to an 8x8 grid and projected by
``jax.random.normal(PRNGKey(seed), (192, 128)) / sqrt(192)``; a sentence is
the mean of its tokens' ``jax.random.normal(fold_in(PRNGKey(11), h), (128,))``
vectors, ``h`` a 31-bit hash of the token. The draws come from the port's
threefry (``utilities/_threefry.py``), within about 2 ulp of JAX's. Scores are
deterministic and self-consistent, not published CLIP values.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch._compile import device_constant
from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities import _threefry
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_EMBED_DIM = 128
_GRID = 8
_TEXT_SEED = 11


def _token_hash(token: str) -> int:
    h = 0
    for ch in token:
        h = (h * 1000003 + ord(ch)) & 0x7FFFFFFF
    return h


class RandomProjectionClipEncoder:
    """Fixed-seed dual encoder with ``get_image_features``/``get_text_features``, on ``device`` (``cuda`` unless given)."""

    embed_dim = _EMBED_DIM

    def __init__(self, seed: int = 0, warn: bool = True, device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = _resolve_device(device)
        n_in = 3 * _GRID * _GRID
        draw = _threefry.normal(_threefry.prng_key(seed, self.device)[None], n_in * _EMBED_DIM)
        self._proj = draw.reshape(n_in, _EMBED_DIM) / n_in**0.5
        if warn:
            rank_zero_warn(
                "CLIP encoder initialized with random projections (pretrained checkpoints cannot be"
                " downloaded in this environment). Scores are deterministic and self-consistent but will"
                " not match published CLIPScore/CLIP-IQA values; pass a real `model` for production use."
            )

    def get_image_features(self, images: Tensor) -> Tensor:
        """``images``: float ``(B, 3, H, W)`` in any range, standardised here. Returns ``(B, 128)``."""
        images = torch.as_tensor(images, device=self.device).to(torch.float32)
        mean = torch.mean(images, dim=(1, 2, 3), keepdim=True)
        std = torch.std(images, dim=(1, 2, 3), keepdim=True, correction=0) + 1e-6  # jnp.std: the population std
        images = (images - mean) / std
        b, _, h, w = images.shape
        # a VALID average pool to the grid (any resolution maps in), cropped to 8x8, then zero-padded to it
        ph, pw = max(h // _GRID, 1), max(w // _GRID, 1)
        pooled = F.avg_pool2d(images, (ph, pw), stride=(ph, pw))[:, :, :_GRID, :_GRID]
        pooled = F.pad(pooled, (0, _GRID - pooled.shape[3], 0, _GRID - pooled.shape[2]))
        with full_fp32():
            return pooled.reshape(b, -1) @ self._proj

    def get_text_features(self, text: Sequence[str]) -> Tensor:
        """One ``(128,)`` vector a sentence: the mean of its lower-cased, space-split tokens' draws."""
        feats = []
        for sentence in text:
            tokens = sentence.lower().split() or [""]
            ids = device_constant([_token_hash(tok) for tok in tokens], self.device, torch.int64)
            feats.append(torch.mean(_threefry.normal_rows(_TEXT_SEED, ids, _EMBED_DIM), dim=0))
        return torch.stack(feats)
