"""Memorization-Informed FID (port of ``torchmetrics_tpu/image/mifid.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.image.fid import _compute_fid
from torchmetrics_tpu_torch.image.kid import _keep_real_features_on_reset
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


def _compute_cosine_distance(features1: Tensor, features2: Tensor, cosine_distance_eps: float = 0.1) -> Tensor:
    """Mean over ``features1`` of the least cosine distance to ``features2``, kept only below the threshold."""
    f1 = features1 / torch.clamp(torch.linalg.vector_norm(features1, dim=1, keepdim=True), min=1e-12)
    f2 = features2 / torch.clamp(torch.linalg.vector_norm(features2, dim=1, keepdim=True), min=1e-12)
    with full_fp32():
        d = 1.0 - torch.abs(f1 @ f2.T)
    mean_min_d = d.min(dim=1).values.mean()
    return torch.where(mean_min_d < cosine_distance_eps, mean_min_d, torch.ones_like(mean_min_d))


class MemorizationInformedFrechetInceptionDistance(Metric):
    """MiFID: FID penalized by memorization of the training set (cosine distance).

    ``feature`` is a tap of the built-in InceptionV3 or a callable; the
    built-in trunk lives on the metric's device.
    """

    _compiled_update_deferred = True  # its trunk streams eagerly (ROADMAP item 6b)

    higher_is_better: bool = False
    is_differentiable: bool = False
    full_state_update: bool = False
    feature_network: str = "inception"
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        weights_path: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, int):
            valid_int_input = (64, 192, 768, 2048)
            if feature not in valid_int_input:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
                )
            from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor

            self.inception = InceptionFeatureExtractor(
                feature=feature, weights_path=weights_path, compute_dtype=compute_dtype, device=self.device
            )
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        if not (isinstance(cosine_distance_eps, float) and 1 >= cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less or equal to 1")
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.cosine_distance_eps = cosine_distance_eps

        self.add_state("real_features", default=[], dist_reduce_fx=None)
        self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract and store features for a batch."""
        features = torch.as_tensor(self.inception(imgs)).to(device=self.device, dtype=torch.float32)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tensor:
        """MiFID = FID / (memorization distance + eps)."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        with full_fp32():
            sigma1, sigma2 = torch.cov(real_features.T), torch.cov(fake_features.T)
        fid = _compute_fid(real_features.mean(dim=0), sigma1, fake_features.mean(dim=0), sigma2)
        distance = _compute_cosine_distance(fake_features, real_features, self.cosine_distance_eps)
        return fid / (distance + 1e-15)

    def reset(self) -> None:
        """Reset; keeps the real features when ``reset_real_features=False``."""
        _keep_real_features_on_reset(self)
