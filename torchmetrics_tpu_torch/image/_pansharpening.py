"""The list states of D_s and QNR: whole fused images, MS and PAN (and PAN_LR) kept until ``compute``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.d_s import _spatial_distortion_index_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


def _add_pansharpening_states(metric: Metric) -> None:
    for name in ("preds", "ms", "pan", "pan_lr"):
        metric.add_state(name, default=[], dist_reduce_fx="cat")


def _append_pansharpening(metric: Metric, preds: Tensor, target: Dict[str, Tensor]) -> None:
    """Append a batch of ``(preds, {ms, pan[, pan_lr]})``, validated as ``spatial_distortion_index`` validates it."""
    if "ms" not in target:
        raise ValueError(f"Expected `target` to contain the key `ms`. Got target: {target.keys()}.")
    if "pan" not in target:
        raise ValueError(f"Expected `target` to contain the key `pan`. Got target: {target.keys()}.")
    on_device = lambda x: None if x is None else torch.as_tensor(x, device=metric.device)  # noqa: E731
    preds, ms, pan, pan_lr = _spatial_distortion_index_update(
        on_device(preds), on_device(target["ms"]), on_device(target["pan"]), on_device(target.get("pan_lr"))
    )
    metric.preds.append(preds)
    metric.ms.append(ms)
    metric.pan.append(pan)
    if pan_lr is not None:
        metric.pan_lr.append(pan_lr)


def _pansharpening_inputs(metric: Metric) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    pan_lr = dim_zero_cat(metric.pan_lr) if len(metric.pan_lr) > 0 else None
    return dim_zero_cat(metric.preds), dim_zero_cat(metric.ms), dim_zero_cat(metric.pan), pan_lr
