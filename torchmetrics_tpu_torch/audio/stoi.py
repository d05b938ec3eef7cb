"""ShortTimeObjectiveIntelligibility (port of ``torchmetrics_tpu/audio/stoi.py``)."""

from __future__ import annotations

from typing import Any

from torch import Tensor

from torchmetrics_tpu_torch.audio._base import _AveragingAudioMetric
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from torchmetrics_tpu_torch.utilities.imports import _PYSTOI_AVAILABLE


class ShortTimeObjectiveIntelligibility(_AveragingAudioMetric):
    """Mean STOI score (the host ``pystoi`` package, as in the JAX package).

    Raises:
        ModuleNotFoundError: if the ``pystoi`` package is not installed.
    """

    is_differentiable = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PYSTOI_AVAILABLE:
            raise ModuleNotFoundError(
                "STOI metric requires that `pystoi` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
            )
        self.fs = fs
        self.extended = extended

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return short_time_objective_intelligibility(preds, target, self.fs, self.extended)
