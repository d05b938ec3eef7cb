"""CLIP-IQA (port of ``torchmetrics_tpu/functional/multimodal/clip_iqa.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.multimodal._encoder import RandomProjectionClipEncoder
from torchmetrics_tpu_torch.utilities.compute import full_fp32

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _clip_iqa_format_prompts(prompts: Tuple = ("quality",)) -> Tuple[List[str], List[str]]:
    """Expand prompt keywords and custom pairs into a flat positive/negative list and the prompts' names."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if not isinstance(p, (str, tuple)):
            raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {_PROMPTS.keys()} if not custom tuple prompts, got {p}."
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        if isinstance(p, tuple) and len(p) != 2:
            raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
        if isinstance(p, tuple) and len(p) == 2:
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
    return prompts_list, prompts_names


def _clip_iqa_get_anchor_vectors(model: Any, prompts_list: List[str]) -> Tensor:
    anchors = model.get_text_features(prompts_list)
    return anchors / torch.linalg.norm(anchors, dim=-1, keepdim=True)


def _clip_iqa_update(images: Tensor, model: Any, data_range: float) -> Tensor:
    images = torch.as_tensor(images).to(torch.float32) / float(data_range)
    img_features = model.get_image_features(images)
    return img_features / torch.linalg.norm(img_features, dim=-1, keepdim=True)


def _clip_iqa_compute(
    img_features: Tensor,
    anchors: Tensor,
    prompts_names: List[str],
    format_as_dict: bool = True,
) -> Union[Tensor, Dict[str, Tensor]]:
    """A softmax over each positive/negative anchor pair: the probability of the positive prompt."""
    with full_fp32():
        logits_per_image = 100 * (img_features @ anchors.to(img_features.device).T)
    probs = torch.softmax(logits_per_image.reshape(logits_per_image.shape[0], -1, 2), dim=-1)[:, :, 0]
    if len(prompts_names) == 1:
        return probs.squeeze()
    if format_as_dict:
        return {p: probs[:, i] for i, p in enumerate(prompts_names)}
    return probs


def clip_image_quality_assessment(
    images: Tensor,
    model_name_or_path: str = "clip_iqa",
    data_range: float = 1.0,
    prompts: Tuple = ("quality",),
    model: Optional[Any] = None,
) -> Union[Tensor, Dict[str, Tensor]]:
    """CLIP-IQA: the probability that each image matches the positive prompt of each pair.

    By default the random-projection encoder, built on the images' device.
    """
    prompts_list, prompts_names = _clip_iqa_format_prompts(prompts)
    clip_model = model if model is not None else RandomProjectionClipEncoder(device=torch.as_tensor(images).device)
    anchors = _clip_iqa_get_anchor_vectors(clip_model, prompts_list)
    img_features = _clip_iqa_update(images, clip_model, data_range)
    return _clip_iqa_compute(img_features, anchors, prompts_names)
