"""Input validation helpers (reference ``torchmetrics/utilities/checks.py:33-39``).

PyTorch runs eagerly, so the value-dependent checks of the functionals run
on every call; on a CUDA tensor each reads one scalar back to the host, as
the reference does.
"""

from __future__ import annotations

from torch import Tensor


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ (reference ``checks.py:33-39``)."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )

