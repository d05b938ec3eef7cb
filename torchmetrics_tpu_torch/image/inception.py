"""Inception Score (port of ``torchmetrics_tpu/image/inception.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class InceptionScore(Metric):
    """Inception Score of generated images: ``exp(E_x KL(p(y|x) || p(y)))``.

    Args:
        feature: ``'logits_unbiased'`` or a tap (64, 192, 768, 2048) of the
            built-in InceptionV3, or a callable returning per-image class logits.
        splits: the number of splits the scores' mean and std are taken over.
        normalize: accepted for the reference's signature; the built-in trunk
            takes uint8 [0, 255] or float [0, 1] images as they come.
        weights_path: optional converted InceptionV3 checkpoint (``.npz``).
        compute_dtype: the trunk's conv dtype (bfloat16 unless given).
        kwargs: the ``Metric`` runtime's options, ``device`` among them; the
            built-in trunk lives on the metric's device.

    ``compute`` splits the features after a permutation drawn from numpy's
    global generator (``np.random.permutation``), as the JAX package does.
    """

    higher_is_better: bool = True
    is_differentiable: bool = False
    full_state_update: bool = False
    feature_network: str = "inception"
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        weights_path: Optional[str] = None,
        compute_dtype: Optional[torch.dtype] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, (str, int)):
            valid_input = ("logits_unbiased", 64, 192, 768, 2048)
            if feature not in valid_input:
                raise ValueError(f"Input to argument `feature` must be one of {valid_input}, but got {feature}.")
            from torchmetrics_tpu_torch.image._inception import InceptionFeatureExtractor

            self.inception = InceptionFeatureExtractor(
                feature=feature, weights_path=weights_path, compute_dtype=compute_dtype, device=self.device
            )
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.splits = splits
        self.add_state("features", default=[], dist_reduce_fx=None)

    def update(self, imgs: Tensor) -> None:
        """Extract and store per-image logits."""
        self.features.append(torch.as_tensor(self.inception(imgs)).to(device=self.device, dtype=torch.float32))

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(mean, std) of the per-split inception scores."""
        features = dim_zero_cat(self.features)
        # a random permutation decorrelates the splits, as the reference's torch.randperm does
        idx = np.random.permutation(features.shape[0])
        features = features[torch.as_tensor(idx, device=features.device)]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        split_size = prob.shape[0] // self.splits
        kl_means = []
        for k in range(self.splits):
            p = prob[k * split_size : (k + 1) * split_size]
            lp = log_prob[k * split_size : (k + 1) * split_size]
            mean_prob = p.mean(dim=0, keepdim=True)
            kl = p * (lp - torch.log(torch.clamp(mean_prob, min=1e-10)))
            kl_means.append(torch.exp(kl.sum(dim=1).mean()))
        kl_arr = torch.stack(kl_means)
        return kl_arr.mean(), kl_arr.std() if kl_arr.numel() > 1 else torch.zeros((), device=kl_arr.device)
