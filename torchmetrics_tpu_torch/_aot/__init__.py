"""The on-disk AOT cache: kernel libraries and step records, so a fresh replica starts without ``nvcc``.

Port of ``torchmetrics_tpu/_aot/`` (the same seven names). With
``TM_TPU_AOT_CACHE`` (or :func:`set_aot_cache`) pointing at a directory, the
port stores under ``<dir>/torch/`` every kernel library it builds (``nvcc``
once for a fleet, then each replica loads the ``.so``) and one record for
each compiled key: a metric's compiled update or forward, ``jit_update`` and
``scan_update``, a stream pool's step and the SPMD engine's step. See
``cache.py`` for the artifact format, the fallback ladder and what a hit
means; ``default_path.py`` for the certified default-path sweep that the
golden manifest (``golden.py``) pins.

This ``__init__`` stays import-light: ``metric.py`` pulls the switch from
``state`` at module scope, everything heavier loads on first use.
"""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch._aot.state import AOT, get_aot_cache, set_aot_cache

__all__ = [
    "AOT",
    "set_aot_cache",
    "get_aot_cache",
    "aot_stats",
    "reset_aot_stats",
    "get_cache",
    "wrap_executable",
]

_LAZY = {"aot_stats", "reset_aot_stats", "get_cache", "wrap_executable"}


def __getattr__(name: str) -> Any:
    if name in _LAZY:
        from torchmetrics_tpu_torch._aot import cache as _cache

        return getattr(_cache, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
