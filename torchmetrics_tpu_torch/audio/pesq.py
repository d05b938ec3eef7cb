"""PerceptualEvaluationSpeechQuality (port of ``torchmetrics_tpu/audio/pesq.py``)."""

from __future__ import annotations

from typing import Any

from torch import Tensor

from torchmetrics_tpu_torch.audio._base import _AveragingAudioMetric
from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE


class PerceptualEvaluationSpeechQuality(_AveragingAudioMetric):
    """Mean PESQ score (the host ``pesq`` package's C DSP, as in the JAX package).

    Raises:
        ModuleNotFoundError: if the ``pesq`` package is not installed.
    """

    is_differentiable = False
    plot_lower_bound: float = -0.5
    plot_upper_bound: float = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes

    def _measure(self, preds: Tensor, target: Tensor) -> Tensor:
        return perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes)
