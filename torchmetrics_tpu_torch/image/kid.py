"""Kernel Inception Distance (port of ``torchmetrics_tpu/image/kid.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """Polynomial kernel matrix between two feature sets, the product in full float32."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with full_fp32():
        return (f1 @ f2.T * gamma + coef) ** degree


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD² estimate from kernel matrices."""
    m = k_xx.shape[0]
    kt_xx_sum = (k_xx.sum(dim=-1) - torch.diagonal(k_xx)).sum()
    kt_yy_sum = (k_yy.sum(dim=-1) - torch.diagonal(k_yy)).sum()
    k_xy_sum = k_xy.sum()
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def _keep_real_features_on_reset(metric: Metric) -> None:
    """``reset`` for KID and MiFID: with ``reset_real_features=False`` the real features survive it."""
    real = metric.real_features
    Metric.reset(metric)
    if not metric.reset_real_features:
        metric.real_features = list(real)  # a list of its own: `forward` keeps the old one by reference


class KernelInceptionDistance(Metric):
    """KID: polynomial-kernel MMD between real and generated features.

    States are per-image feature lists (the estimator draws raw feature
    subsets). ``feature`` is a tap of the built-in InceptionV3 or a callable,
    as for FID; the built-in trunk lives on the metric's device. ``compute``
    draws its ``subsets`` pairs of permutations from numpy's global generator
    (``np.random.permutation``, real then generated, as the JAX package
    does), all of them on the host first, copies them to the device once, and
    reads nothing back before the mean and std.
    """

    _compiled_update_deferred = True  # its trunk streams eagerly (ROADMAP item 6b)

    higher_is_better: bool = False
    is_differentiable: bool = False
    full_state_update: bool = False
    feature_network: str = "inception"
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Union[str, int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        weights_path: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, (str, int)):
            from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor

            self.inception = InceptionFeatureExtractor(
                feature=feature, weights_path=weights_path, compute_dtype=compute_dtype, device=self.device
            )
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")

        self.subsets = subsets
        self.subset_size = subset_size
        self.degree = degree
        self.gamma = gamma
        self.coef = coef
        self.reset_real_features = reset_real_features
        self.normalize = normalize

        self.add_state("real_features", default=[], dist_reduce_fx=None)
        self.add_state("fake_features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract and store features for a batch."""
        features = torch.as_tensor(self.inception(imgs)).to(device=self.device, dtype=torch.float32)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(mean, std) of MMD² over random feature subsets."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        perms = np.empty((self.subsets, 2, self.subset_size), dtype=np.int64)
        for s in range(self.subsets):
            perms[s, 0] = np.random.permutation(n_samples_real)[: self.subset_size]
            perms[s, 1] = np.random.permutation(n_samples_fake)[: self.subset_size]
        perms = torch.from_numpy(perms).to(real_features.device)

        kid_scores = []
        for s in range(self.subsets):
            f_real = real_features[perms[s, 0]]
            f_fake = fake_features[perms[s, 1]]
            k_xx = poly_kernel(f_real, f_real, self.degree, self.gamma, self.coef)
            k_xy = poly_kernel(f_real, f_fake, self.degree, self.gamma, self.coef)
            k_yy = poly_kernel(f_fake, f_fake, self.degree, self.gamma, self.coef)
            kid_scores.append(maximum_mean_discrepancy(k_xx, k_xy, k_yy))
        kid = torch.stack(kid_scores)
        return kid.mean(), kid.std() if kid.numel() > 1 else torch.zeros((), device=kid.device)

    def reset(self) -> None:
        """Reset; keeps the real features when ``reset_real_features=False``."""
        _keep_real_features_on_reset(self)
