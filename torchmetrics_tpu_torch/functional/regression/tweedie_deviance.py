"""Tweedie deviance score (port of ``torchmetrics_tpu/functional/regression/tweedie_deviance.py``).

The observation count is float32, as in the JAX package, so that the two
agree; it counts exactly up to 2**24 observations (16,777,216) and rounds
past that.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, targets)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    targets = torch.as_tensor(targets, dtype=torch.float32)

    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:  # Poisson
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:  # Gamma
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = torch.pow(torch.clamp(targets, min=0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    return torch.sum(deviance_score), torch.full((), targets.numel(), dtype=torch.float32, device=targets.device)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Tweedie deviance score.

    Example:
        >>> import torch
        >>> tweedie_deviance_score(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.5, 2.5, 4.5]), power=0)
        tensor(0.9167)
    """
    s, n = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(s, n)
