"""Rank-zero-aware printing helpers.

Parity target: reference ``torchmetrics/utilities/prints.py:22-56``. The rank
is the ``torch.distributed`` rank when a process group is initialised, else 0.
"""

from __future__ import annotations

import logging
import warnings
from functools import wraps
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger("torchmetrics_tpu_torch")


def _process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Call ``fn`` only on process 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, category: Any = UserWarning, stacklevel: int = 2, **kwargs: Any) -> None:
    warnings.warn(message, category=category, stacklevel=stacklevel, **kwargs)


@rank_zero_only
def rank_zero_info(message: str, **kwargs: Any) -> None:
    log.info(message, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, **kwargs: Any) -> None:
    log.debug(message, **kwargs)
