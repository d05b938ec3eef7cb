"""Lazy optional-dependency flags (port of ``torchmetrics_tpu/utilities/imports.py:15-46``).

A flag is true when its package can be imported; it is probed with
``importlib.util.find_spec`` the first time it is read, never at import.
Only the flags the port reads are kept: the host backends of PESQ and STOI,
and matplotlib for ``plot``.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def package_available(name: str) -> bool:
    """True iff ``name`` is importable (spec probe only, no import side effects)."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


class RequirementCache:
    """Boolean-ish lazy probe for an optional dependency."""

    def __init__(self, module: str) -> None:
        self.module = module

    def __bool__(self) -> bool:
        return package_available(self.module)

    def __repr__(self) -> str:
        return f"RequirementCache({self.module}={bool(self)})"


_MATPLOTLIB_AVAILABLE = RequirementCache("matplotlib")
_PESQ_AVAILABLE = RequirementCache("pesq")
_PYSTOI_AVAILABLE = RequirementCache("pystoi")
