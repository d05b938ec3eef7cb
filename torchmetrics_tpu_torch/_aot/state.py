"""Process-wide AOT-cache switch, the one object the build seams touch (JAX ``_aot/state.py``).

Every seam that builds a step (a metric's compiled update or forward, a
stream pool's step, the SPMD engine's step) and the kernel-library loader
(``utilities/nvcc.py``) guard themselves with::

    if _AOT.active:
        ...consult the on-disk cache...

where ``_AOT`` is this module's :data:`AOT` singleton. ``active`` lives in a
``__slots__`` slot, so with the cache unset a seam pays one slot load and one
branch when it builds a key, and nothing on a replay.

Switches:

- env ``TM_TPU_AOT_CACHE=/path`` points the on-disk cache at a directory
  (read at import); the JAX package reads the same variable;
- :func:`set_aot_cache` re-points or disables it at runtime.

The port keeps its artifacts under ``<dir>/torch/`` and never touches the
directory's top level, where the JAX package keeps its executables, or
``<dir>/xla``, JAX's own compilation cache. There is no counterpart of the JAX
package's second layer (``_arm_xla_cache``/``ensure_xla_cache``): PyTorch has
no persistent compilation cache to arm, and a CUDA graph cannot be written to
disk (``cache.py`` says what the port stores instead).

This module stays import-light (no torch, no numpy): ``metric.py`` imports it
at module scope.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["AOT", "set_aot_cache", "get_aot_cache"]


class _AotState:
    """Mutable singleton holding the global AOT-cache switch.

    ``__slots__`` keeps the ``active`` read a plain slot load and makes
    accidental attribute growth an error.
    """

    __slots__ = ("active", "cache_dir")

    def __init__(self) -> None:
        path = os.environ.get("TM_TPU_AOT_CACHE", "").strip()
        self.cache_dir: Optional[str] = path or None
        self.active = bool(path)


AOT = _AotState()


def set_aot_cache(directory: Optional[str]) -> None:
    """Point the on-disk AOT cache at ``directory``; ``None`` (or ``""``) turns it off.

    The directory is created lazily on the first artifact write. An
    unwritable directory degrades to building as if there were no cache,
    with an ``aot_cache_unwritable`` bus event: it never raises on the
    update path. With the cache off, new keys build without touching disk.
    """
    path = (directory or "").strip() if isinstance(directory, str) or directory is None else str(directory)
    AOT.cache_dir = path or None
    AOT.active = bool(path)


def get_aot_cache() -> Optional[str]:
    """The current AOT cache directory as it was set (``None`` when the cache is off)."""
    return AOT.cache_dir
