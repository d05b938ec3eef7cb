"""PermutationInvariantTraining (port of ``torchmetrics_tpu/audio/pit.py``)."""

from __future__ import annotations

from typing import Any, Callable

from torch import Tensor

from torchmetrics_tpu_torch.audio._base import _AveragingAudioMetric
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training

# the keyword arguments that go to the Metric base class; every other one goes to `metric_func`
_BASE_KWARGS = (
    "device", "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn", "sync_on_compute",
    "compute_with_cache", "distributed_available_fn", "cat_state_capacity",
)


class PermutationInvariantTraining(_AveragingAudioMetric):
    """Mean best-permutation metric value over speaker assignments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, mode="speaker-wise", device="cpu")
        >>> bool(pit(preds, target) < 0)
        False
    """

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {key: kwargs.pop(key) for key in list(kwargs) if key in _BASE_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ("speaker-wise", "permutation-wise"):
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.metric_kwargs = kwargs  # the rest go to metric_func

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        best_metric, _ = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.metric_kwargs
        )
        return best_metric
