"""CLIPScore (port of ``torchmetrics_tpu/functional/multimodal/clip_score.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.multimodal._encoder import RandomProjectionClipEncoder


def _get_clip_model(model_name_or_path: Optional[str], model: Optional[Any], device: Any = None) -> Any:
    if model is not None:
        return model
    return RandomProjectionClipEncoder(device=device)


def _images_device(images: Union[Tensor, List[Tensor]]) -> Optional[torch.device]:
    first = images[0] if isinstance(images, list) and images else images
    return first.device if isinstance(first, Tensor) else None


def _clip_score_update(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model: Any,
) -> Tuple[Tensor, int]:
    """Per-pair ``100 * cosine(image embedding, text embedding)`` and the number of pairs."""
    if not isinstance(images, list):
        images = [images] if images.ndim == 3 else list(images)
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )
    img_batch = torch.stack([torch.as_tensor(i).to(torch.float32) for i in images])
    img_features = model.get_image_features(img_batch)
    img_features = img_features / torch.linalg.norm(img_features, dim=-1, keepdim=True)
    txt_features = model.get_text_features(text)
    txt_features = txt_features / torch.linalg.norm(txt_features, dim=-1, keepdim=True)
    score = 100 * torch.sum(img_features * txt_features.to(img_features.device), dim=-1)
    return score, len(text)


def clip_score(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model_name_or_path: Optional[str] = None,
    model: Optional[Any] = None,
) -> Tensor:
    """CLIPScore: the mean of ``100 * cosine`` between image and caption embeddings, clamped at 0.

    ``model`` is any object with ``get_image_features(images)`` and
    ``get_text_features(list_of_str)``; by default the random-projection
    encoder, built on the images' device (self-consistent scores only).
    """
    clip_model = _get_clip_model(model_name_or_path, model, _images_device(images))
    score, _ = _clip_score_update(images, text, clip_model)
    score = torch.mean(score)
    return torch.clamp(score, min=0.0)
