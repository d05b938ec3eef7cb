"""CLIPImageQualityAssessment class (port of ``torchmetrics_tpu/multimodal/clip_iqa.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

from torch import Tensor

from torchmetrics_tpu_torch.functional.multimodal._encoder import RandomProjectionClipEncoder
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import (
    _clip_iqa_compute,
    _clip_iqa_format_prompts,
    _clip_iqa_get_anchor_vectors,
    _clip_iqa_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA: the probability that each image matches the positive prompt of each pair.

    The prompts' anchors are computed once, at construction, on the metric's
    device. ``weights_path=``/``tokenizer=`` load a converted CLIP checkpoint
    as :class:`~torchmetrics_tpu_torch.multimodal.CLIPScore` does.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    feature_network: str = "model"
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        model_name_or_path: str = "clip_iqa",
        data_range: float = 1.0,
        prompts: Tuple = ("quality",),
        model: Optional[Any] = None,
        weights_path: Optional[str] = None,
        tokenizer: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if model is None and weights_path:
            from torchmetrics_tpu_torch.multimodal._clip_encoder import ClipExtractor

            model = ClipExtractor(weights_path, tokenizer=tokenizer, device=self.device)
        self.data_range = data_range
        self.prompts_list, self.prompts_names = _clip_iqa_format_prompts(prompts)
        self.model = model if model is not None else RandomProjectionClipEncoder(device=self.device)
        self.anchors = _clip_iqa_get_anchor_vectors(self.model, self.prompts_list).to(self.device)
        self.add_state("probs_list", default=[], dist_reduce_fx="cat")

    def update(self, images: Tensor) -> None:
        img_features = _clip_iqa_update(images, self.model, self.data_range)
        probs = _clip_iqa_compute(img_features, self.anchors, self.prompts_names, format_as_dict=False)
        self.probs_list.append(probs.reshape(images.shape[0], -1).to(self.device))

    def compute(self) -> Union[Tensor, Dict[str, Tensor]]:
        probs = dim_zero_cat(self.probs_list)
        if len(self.prompts_names) == 1:
            return probs.squeeze()
        return {p: probs[:, i] for i, p in enumerate(self.prompts_names)}
