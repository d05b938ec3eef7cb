"""Fault injection for the SPMD engine's step (test and chaos harness).

Port of ``torchmetrics_tpu/_spmd/faultinject.py``. The engine's sync runs
inside its step (a CUDA graph on the card), out of reach of the eager
transport seam (``utilities.distributed._transport``). The dispatch seam
here is its counterpart: every step and every compute of the engine goes
through :func:`dispatch`, so tests can make the step itself fail the way a
lost card or a failed launch does (a ``RuntimeError`` out of the step) and
check the engine's degradation contract without a real hardware fault.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Optional

__all__ = ["dispatch", "inject_step_failure"]

# None = healthy; otherwise a zero-arg callable invoked before every
# dispatch, which raises to simulate the failure
_failure: Optional[Callable[[], None]] = None


def dispatch(fn: Callable, *args: Any) -> Any:
    """Run one step (or compute) of the engine through the patchable seam."""
    if _failure is not None:
        _failure()
    return fn(*args)


@contextlib.contextmanager
def inject_step_failure(
    exc_factory: Optional[Callable[[], BaseException]] = None,
    times: Optional[int] = None,
) -> Iterator[None]:
    """Make the engine's dispatches raise while the context is active.

    ``times`` bounds how many dispatches fail (None = all of them); the
    default exception models a runtime fault of the step (a ``RuntimeError``,
    which the engine treats as degradable; programming errors are not).
    """
    make = exc_factory or (lambda: RuntimeError("injected in-graph collective failure"))
    remaining = [times]

    def fail() -> None:
        if remaining[0] is not None:
            if remaining[0] <= 0:
                return
            remaining[0] -= 1
        raise make()

    global _failure
    prev = _failure
    _failure = fail
    try:
        yield
    finally:
        _failure = prev
