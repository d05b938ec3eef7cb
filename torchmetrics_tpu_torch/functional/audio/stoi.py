"""STOI (port of ``torchmetrics_tpu/functional/audio/stoi.py``).

As in the JAX package it runs on the host through the ``pystoi`` package,
from numpy, behind a requirement flag; the scores come back to the input's
device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.imports import _PYSTOI_AVAILABLE


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
) -> Tensor:
    """STOI score through the host ``pystoi`` package, per signal of the trailing axis.

    Raises:
        ModuleNotFoundError: if the ``pystoi`` package is not installed.
    """
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "ShortTimeObjectiveIntelligibility metric requires that `pystoi` is installed."
            " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
        )
    from pystoi import stoi as stoi_backend

    _check_same_shape(preds, target)
    preds_np = preds.detach().cpu().numpy().astype(np.float32)
    target_np = target.detach().cpu().numpy().astype(np.float32)
    if preds_np.ndim == 1:
        return torch.tensor(stoi_backend(target_np, preds_np, fs, extended), dtype=torch.float32, device=preds.device)
    preds_flat = preds_np.reshape(-1, preds_np.shape[-1])
    target_flat = target_np.reshape(-1, target_np.shape[-1])
    scores = [stoi_backend(t, p, fs, extended) for t, p in zip(target_flat, preds_flat)]
    return torch.tensor(np.asarray(scores, dtype=np.float32), device=preds.device).reshape(preds.shape[:-1])
