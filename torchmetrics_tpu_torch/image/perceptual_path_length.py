"""Perceptual Path Length (port of ``torchmetrics_tpu/image/perceptual_path_length.py``).

PPL measures the smoothness of a generator's latent space: perceptual
distances between images generated from epsilon-separated latent
interpolations, divided by epsilon².
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric, _resolve_device


def _validate_generator_model(generator: Any, conditional: bool = False) -> None:
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must have a `sample` method with signature `sample(num_samples: int)`"
        )
    if not callable(generator):
        raise NotImplementedError("The generator must be callable: `generator(z[, labels]) -> images`")
    if conditional and not hasattr(generator, "num_classes"):
        raise AttributeError("The generator must have a `num_classes` attribute when `conditional=True`")


def _unit(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _interpolate(latents1: Tensor, latents2: Tensor, epsilon: float, interpolation_method: str) -> Tensor:
    """Move ``latents1`` an epsilon step towards ``latents2``."""
    eps = epsilon
    if interpolation_method == "lerp":
        return latents1 + (latents2 - latents1) * eps
    if interpolation_method in ("slerp_any", "slerp_unit"):
        a = _unit(latents1)
        b = _unit(latents2)
        d = torch.sum(a * b, dim=-1, keepdim=True)
        p = eps * torch.arccos(torch.clamp(d, -1 + 1e-7, 1 - 1e-7))
        c = _unit(b - d * a)
        interp = a * torch.cos(p) + c * torch.sin(p)
        if interpolation_method == "slerp_any":
            interp = interp * torch.linalg.vector_norm(latents1, dim=-1, keepdim=True)
        return interp
    raise ValueError(f"Interpolation method {interpolation_method} not supported.")


def perceptual_path_length(
    generator: Any,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Union[Callable, None] = None,
    device: Optional[torch.device] = None,
    seed: int = 42,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Compute PPL: returns (mean, std, raw distances).

    ``device`` (a ``torch.device``; ``cuda`` unless given, raising where there
    is none, the counterpart of the JAX package's ``jax.Device`` check) is where the latents go and where ``sim_net=None``
    builds the LPIPS-VGG network. The generator's ``sample(n)`` gives latents
    and ``generator(z[, labels])`` images; conditional labels come from
    ``np.random.default_rng(seed)``, as in the JAX package.
    """
    if device is not None and not isinstance(device, torch.device):
        raise ValueError(f"Argument `device` must be a `torch.device` or None, but got {device!r}.")
    _validate_generator_model(generator, conditional)
    if not (isinstance(num_samples, int) and num_samples > 0):
        raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError(f"Argument `batch_size` must be a positive integer, but got {batch_size}.")
    if interpolation_method not in ("lerp", "slerp_any", "slerp_unit"):
        raise ValueError("Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit'.")
    if not (isinstance(epsilon, float) and epsilon > 0):
        raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}.")
    for name, v in (("lower_discard", lower_discard), ("upper_discard", upper_discard)):
        if v is not None and not (isinstance(v, float) and 0 <= v <= 1):
            raise ValueError(f"Argument `{name}` must be a float in [0, 1] or None, but got {v}.")
    device = _resolve_device(device)

    if sim_net is None:
        from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor

        sim_net = LPIPSExtractor(net_type="vgg", device=device)

    rng = np.random.default_rng(seed)
    distances = []
    num_batches = int(np.ceil(num_samples / batch_size))
    with torch.no_grad():
        for _ in range(num_batches):
            latents1 = torch.as_tensor(generator.sample(batch_size), device=device)
            latents2 = torch.as_tensor(generator.sample(batch_size), device=device)
            latents2_eps = _interpolate(latents1, latents2, epsilon, interpolation_method)

            if conditional:
                labels = torch.as_tensor(rng.integers(0, generator.num_classes, batch_size), device=device)
                imgs1 = generator(latents1, labels)
                imgs2 = generator(latents2_eps, labels)
            else:
                imgs1 = generator(latents1)
                imgs2 = generator(latents2_eps)
            imgs1 = torch.as_tensor(imgs1, device=device).to(torch.float32)
            imgs2 = torch.as_tensor(imgs2, device=device).to(torch.float32)
            if resize is not None:
                # jax.image.resize's bilinear: half-pixel centres, antialiased when it shrinks
                imgs1 = F.interpolate(imgs1, size=(resize, resize), mode="bilinear", align_corners=False, antialias=True)
                imgs2 = F.interpolate(imgs2, size=(resize, resize), mode="bilinear", align_corners=False, antialias=True)
            d = torch.as_tensor(sim_net(imgs1, imgs2), device=device).reshape(-1) / (epsilon**2)
            distances.append(d)
    distances = torch.cat(distances)[:num_samples]

    inf = torch.tensor(float("inf"), device=device)
    lower = torch.quantile(distances, lower_discard) if lower_discard is not None else -inf
    upper = torch.quantile(distances, upper_discard) if upper_discard is not None else inf
    keep = (distances >= lower) & (distances <= upper)
    kept = torch.where(keep, distances, 0.0)
    n = torch.clamp(keep.sum(), min=1)
    mean = kept.sum() / n
    var = torch.sum(torch.where(keep, (distances - mean) ** 2, 0.0)) / torch.clamp(n - 1, min=1)
    return mean, torch.sqrt(var), distances


class PerceptualPathLength(Metric):
    """PPL as a Metric: ``update(generator)`` stores the generator, ``compute`` runs :func:`perceptual_path_length`.

    The evaluation runs on the metric's device, where ``sim_net=None`` builds
    the LPIPS-VGG network.
    """

    _compiled_update_deferred = True  # its trunk streams eagerly (ROADMAP item 6b)

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = True
    feature_network: str = "sim_net"

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Union[Callable, None] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self.add_state("_generator_holder", default=[], dist_reduce_fx=None)

    def update(self, generator: Any) -> None:
        """Store the generator to evaluate at ``compute`` time."""
        _validate_generator_model(generator, self.conditional)
        self._generator = generator
        self._generator_holder.append(torch.zeros(1, device=self.device))

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Run the PPL evaluation with the stored generator."""
        if not hasattr(self, "_generator"):
            raise RuntimeError("No generator provided; call `update(generator)` first.")
        return perceptual_path_length(
            self._generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self.sim_net,
            device=self.device,
        )
