"""CLIPScore class (port of ``torchmetrics_tpu/multimodal/clip_score.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update, _get_clip_model
from torchmetrics_tpu_torch.metric import Metric


class CLIPScore(Metric):
    """CLIPScore: the mean of ``100 * cosine`` between images and captions, clamped at 0.

    ``model`` is any object with ``get_image_features``/``get_text_features``;
    ``weights_path=`` loads a converted CLIP checkpoint (a :class:`ClipExtractor`
    on the metric's device, with ``tokenizer=``); otherwise the
    random-projection encoder, on the metric's device.

    Example:
        >>> import torch
        >>> metric = CLIPScore(device="cpu")  # doctest: +SKIP
        >>> img = torch.rand(3, 224, 224, generator=torch.Generator().manual_seed(42))
        >>> score = metric(img, "a photo of a cat")  # doctest: +SKIP
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    feature_network: str = "model"
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        model: Optional[Any] = None,
        weights_path: Optional[str] = None,
        tokenizer: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if model is None and weights_path:
            from torchmetrics_tpu_torch.multimodal._clip_encoder import ClipExtractor

            model = ClipExtractor(weights_path, tokenizer=tokenizer, device=self.device)
        self.model = _get_clip_model(model_name_or_path, model, self.device)
        self.add_state("score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n_samples", default=torch.tensor(0, dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, images: Union[Tensor, List[Tensor]], text: Union[str, List[str]]) -> None:
        score, n_samples = _clip_score_update(images, text, self.model)
        self.score += torch.sum(score).to(self.score.device)
        self.n_samples += n_samples

    def compute(self) -> Tensor:
        return torch.clamp(self.score / self.n_samples, min=0.0)
