"""PESQ (port of ``torchmetrics_tpu/functional/audio/pesq.py``).

PESQ is ITU-T P.862's sequential DSP pipeline. As in the JAX package it runs
on the host through the C-backed ``pesq`` package, from numpy, behind a
requirement flag; the scores come back to the input's device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> Tensor:
    """PESQ score through the host ``pesq`` package, per signal of the trailing axis.

    Raises:
        ModuleNotFoundError: if the ``pesq`` package is not installed.
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pesq`."
        )
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    _check_same_shape(preds, target)

    preds_np = preds.detach().cpu().numpy().astype(np.float32)
    target_np = target.detach().cpu().numpy().astype(np.float32)
    if preds_np.ndim == 1:
        return torch.tensor(pesq_backend.pesq(fs, target_np, preds_np, mode), dtype=torch.float32, device=preds.device)
    preds_np = preds_np.reshape(-1, preds_np.shape[-1])
    target_np = target_np.reshape(-1, target_np.shape[-1])
    if n_processes == 1:
        scores = [pesq_backend.pesq(fs, t, p, mode) for t, p in zip(target_np, preds_np)]
    else:
        scores = pesq_backend.pesq_batch(fs, target_np, preds_np, mode, n_processor=n_processes)
    return torch.tensor(np.asarray(scores, dtype=np.float32), device=preds.device).reshape(preds.shape[:-1])
