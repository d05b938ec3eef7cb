"""Input validation helpers (reference ``torchmetrics/utilities/checks.py:33-39``).

The value-dependent checks of the functionals read their verdict back to the
host, as the reference does. They run on every eager call and are skipped
inside a compiled update step (:func:`_in_compiled_step`), the counterpart of
the JAX package's ``_is_concrete``: there the step carries them as a device
flag vector built from the ``*_value_flags`` blocks below, read back at the
next eager update, ``compute()`` or ``reset()``. The flag is one explicit
switch, set the same way on the CPU, where the step runs eagerly, and on the
card, where it is captured into a CUDA graph, so both take the same branches.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.prints import rank_zero_only


@rank_zero_only
def rank_zero_print(*args: Any, **kwargs: Any) -> None:
    print(*args, **kwargs)


_STEP = threading.local()


def _in_compiled_step() -> bool:
    """True while a compiled update step runs: host-reading checks must not run."""
    return getattr(_STEP, "depth", 0) > 0


@contextlib.contextmanager
def _compiled_step() -> Iterator[None]:
    """Mark the body as a compiled update step (captured on the card, run eagerly on the CPU)."""
    _STEP.depth = getattr(_STEP, "depth", 0) + 1
    try:
        yield
    finally:
        _STEP.depth -= 1


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ (reference ``checks.py:33-39``)."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


# ------------------------------------------------------------------ traced
# Building blocks for ``Metric._traced_value_flags`` (JAX ``checks.py:69-110``):
# each returns a static message tuple and a same-length boolean flag vector
# computed on the device, with no host read. The tuple, and so the flag
# length, is the same for every argument signature of an instance (a check
# that does not apply to a dtype gives a constant False, never a missing
# entry), so the device-side OR accumulator stays aligned.


def _target_set_value_flags(target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tuple[str, ...], Tensor]:
    """Flag for "target values outside {0, 1} (and ``ignore_index``)", in the JAX package's words.

    The offending values are not listed: the check runs on the device,
    where listing them would read them back.
    """
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    ok = (target == 0) | (target == 1)
    if ignore_index is not None:
        ok = ok | (target == ignore_index)
    msgs = (
        "Detected the following values in `target` outside of the expected set, but expected"
        f" only the following values {sorted(allowed)} (offending value list omitted: check"
        " ran fused on-device).",
    )
    return msgs, torch.any(~ok).reshape(1)


def _no_value_flags(*args: Any, **_kwargs: Any) -> Tuple[Tuple[str, ...], Tensor]:
    """For metrics whose validation reads only shapes, dtypes and arguments: nothing to fuse."""
    device = next((a.device for a in args if isinstance(a, Tensor)), None)
    return (), torch.zeros((0,), dtype=torch.bool, device=device)


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
