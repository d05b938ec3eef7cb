"""Input validation helpers (reference ``torchmetrics/utilities/checks.py:33-39``).

PyTorch runs eagerly, so the value-dependent checks of the functionals run
on every call; on a CUDA tensor each reads one scalar back to the host, as
the reference does.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.prints import rank_zero_only


@rank_zero_only
def rank_zero_print(*args: Any, **kwargs: Any) -> None:
    print(*args, **kwargs)


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ (reference ``checks.py:33-39``)."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )



def _allclose_tree(a: Any, b: Any) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_allclose_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_allclose_tree(x, y) for x, y in zip(a, b))
    return bool(torch.allclose(torch.as_tensor(a), torch.as_tensor(b)))


def check_forward_full_state_property(
    metric_class: type,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare: Sequence[int] = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Check whether ``full_state_update=False`` is safe for a metric class (reference ``checks.py:636``).

    Runs ``forward`` on the double-update path (``full_state_update=True``)
    and on the single-update path, checks that every batch value and the
    final ``compute`` agree, then prints each path's time so an author can
    choose the flag with evidence.
    """
    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):
        full_state_update = True

    class PartState(metric_class):
        full_state_update = False

    full_state = FullState(**init_args)
    part_state = PartState(**init_args)
    equal = True
    for _ in range(num_update_to_compare[0]):
        equal = equal and _allclose_tree(full_state(**input_args), part_state(**input_args))
    equal = equal and _allclose_tree(full_state.compute(), part_state.compute())
    if not equal:
        rank_zero_print("Full state and reduced state did not match; recommended setting `full_state_update=True`.")
        return

    for metric, name in ((full_state, "Full"), (part_state, "Partial")):
        for num in num_update_to_compare:
            metric.reset()
            start = time.perf_counter()
            for _ in range(reps):
                for _ in range(num):
                    metric(**input_args)
            end = time.perf_counter()
            rank_zero_print(f"{name} state for {num} steps took: {(end - start) / reps}")
    rank_zero_print("Recommended setting `full_state_update=False`")
