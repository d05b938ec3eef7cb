"""Fréchet Inception Distance (port of ``torchmetrics_tpu/image/fid.py``).

- Streaming states are per-distribution feature sums ``(d,)``, outer-product
  sums ``(d, d)`` and sample counts: O(d²) memory, order independent,
  summed across processes.
- ``tr sqrt(S1 S2)`` is ``tr sqrtm(S1^{1/2} S2 S1^{1/2})`` from two symmetric
  eigendecompositions, as in the JAX package.
- Everything stays float32, with TF32 off for every matrix product, the
  counterpart of the JAX package's ``precision="highest"``.
- ``feature`` is an int (a tap of the built-in InceptionV3, see
  ``_inception.py``) or any callable ``images -> (N, d)`` with ``num_features``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.compute import full_fp32


def _sqrtm_psd_trace_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """``tr sqrt(sigma1 @ sigma2)`` for symmetric PSD inputs via ``eigh``."""
    with full_fp32():
        w1, v1 = torch.linalg.eigh(sigma1)
        sqrt_s1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))[None, :]) @ v1.T
        inner = (sqrt_s1 @ sigma2) @ sqrt_s1
        w = torch.linalg.eigvalsh((inner + inner.T) / 2.0)
    return torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """Fréchet distance between two multivariate Gaussians."""
    diff = mu1 - mu2
    tr_covmean = _sqrtm_psd_trace_product(sigma1, sigma2)
    return torch.dot(diff, diff) + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_covmean


class FrechetInceptionDistance(Metric):
    """FID between streamed real and generated image distributions.

    Args:
        feature: an int in {64, 192, 768, 2048} selecting the built-in
            InceptionV3 tap, or a callable mapping ``(N, 3, H, W)`` images to
            ``(N, d)`` features and exposing ``num_features``.
        reset_real_features: if False, ``reset()`` keeps the real statistics.
        normalize: if True, inputs are floats in [0, 1]; else uint8 [0, 255].
        weights_path: optional converted InceptionV3 checkpoint (``.npz``).
        compute_dtype: the trunk's conv dtype (bfloat16 unless given).
        kwargs: the ``Metric`` runtime's options, ``device`` among them; the
            built-in trunk lives on the metric's device.
    """

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

            num_features = feature
            self.inception = InceptionFeatureExtractor(
                feature=feature, weights_path=weights_path, compute_dtype=compute_dtype, device=self.device
            )
        elif callable(feature):
            self.inception = feature
            num_features = getattr(feature, "num_features", None)
            if num_features is None:
                raise ValueError(
                    "When passing a callable as `feature`, it must expose a `num_features` attribute"
                    " with the feature dimensionality."
                )
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.num_features = num_features

        d = num_features
        self.add_state("real_features_sum", torch.zeros(d), dist_reduce_fx="sum")
        self.add_state("real_features_cov_sum", torch.zeros((d, d)), dist_reduce_fx="sum")
        self.add_state("real_features_num_samples", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("fake_features_sum", torch.zeros(d), dist_reduce_fx="sum")
        self.add_state("fake_features_cov_sum", torch.zeros((d, d)), dist_reduce_fx="sum")
        self.add_state("fake_features_num_samples", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features for a batch and fold them into the running statistics, in place."""
        features = torch.as_tensor(self.inception(imgs)).to(device=self.device, dtype=torch.float32)
        if features.ndim == 1:
            features = features[None, :]
        with full_fp32():
            f_cov = features.T @ features
        prefix = "real" if real else "fake"
        getattr(self, f"{prefix}_features_sum").add_(features.sum(dim=0))
        getattr(self, f"{prefix}_features_cov_sum").add_(f_cov)
        getattr(self, f"{prefix}_features_num_samples").add_(features.shape[0])

    def compute(self) -> Tensor:
        """FID from the accumulated sufficient statistics."""
        if bool(self.real_features_num_samples < 2) or bool(self.fake_features_num_samples < 2):
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        n_real, n_fake = self.real_features_num_samples, self.fake_features_num_samples
        mean_real = self.real_features_sum / n_real
        mean_fake = self.fake_features_sum / n_fake
        cov_real = (self.real_features_cov_sum - n_real * torch.outer(mean_real, mean_real)) / (n_real - 1)
        cov_fake = (self.fake_features_cov_sum - n_fake * torch.outer(mean_fake, mean_fake)) / (n_fake - 1)
        return _compute_fid(mean_real, cov_real, mean_fake, cov_fake)

    def reset(self) -> None:
        """Reset states; keeps the real statistics when ``reset_real_features=False``."""
        if self.reset_real_features:
            super().reset()
            return
        # copies: states are updated in place, and `forward` keeps the pre-reset ones by reference
        real = {k: getattr(self, k).clone() for k in self._defaults if k.startswith("real_")}
        super().reset()
        for key, value in real.items():
            setattr(self, key, value)
