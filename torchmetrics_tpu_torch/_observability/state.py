"""Process-wide telemetry switch — the ONE object hot paths may touch.

Every instrumentation site in the runtime guards itself with::

    if _OBS.enabled:
        ...record...

where ``_OBS`` is the module-level :data:`OBS` singleton imported at the
instrumented module's top level. ``enabled`` lives in a ``__slots__`` slot,
so the disabled path costs exactly one attribute load and one branch — no
dict probes on the metric instance, no allocation, no function call. That
is the whole contract of the kill switch: with telemetry off, the runtime
is indistinguishable from a build without the instrumentation.

Switches:

- env ``TM_TPU_TELEMETRY=1`` enables collection at import time (default off);
- :func:`set_telemetry_enabled` toggles it at runtime;
- :func:`set_telemetry_sampling` controls how often latency samples are
  taken on the hot paths (every Nth call; counters are always exact).

The request-tracing layer (``tracing.py``) rides the same object with its
own independent slot bool (``OBS.tracing``, env ``TM_TPU_TRACING=1``): span
collection can be on while counters are off and vice versa, and each seam
pays exactly one slot load + branch per switch it honors.

The continuous-profiling layer (``profiling.py``) follows the same pattern
with ``OBS.profiling`` (env ``TM_TPU_PROFILING=1``): device-time accounting,
MFU/roofline gauges, and per-tenant cost meters all hang off one slot bool,
so the disabled runtime pays one load + branch per step seam. The setter
lives in ``profiling.set_profiling_enabled``.

The switches and their environment names are the JAX package's
(``torchmetrics_tpu/_observability/state.py``), so a deployment's settings
carry over unchanged.

This module must stay import-light (no torch, no numpy): it is imported by
``metric.py`` at module scope.
"""

from __future__ import annotations

import os

__all__ = [
    "OBS",
    "set_telemetry_enabled",
    "telemetry_enabled",
    "set_telemetry_sampling",
]

DEFAULT_SAMPLE_EVERY = 16


class _ObsState:
    """Mutable singleton holding the global telemetry switches.

    ``__slots__`` keeps the ``enabled`` read a plain slot load (the hot-path
    branch) and makes accidental attribute growth an error.
    """

    __slots__ = ("enabled", "sample_every", "profile_scopes", "tracing", "profiling")

    def __init__(self) -> None:
        self.enabled = os.environ.get("TM_TPU_TELEMETRY", "") == "1"
        self.sample_every = DEFAULT_SAMPLE_EVERY
        self.profile_scopes = True
        # span tracing (tracing.py) — independent of the counter switch so a
        # deployment can trace sampled requests without paying for counters
        # (or vice versa); the setter lives in tracing.set_tracing_enabled
        self.tracing = os.environ.get("TM_TPU_TRACING", "") == "1"
        # continuous profiling (profiling.py) — device-time accounting, MFU
        # gauges, tenant cost meters; the setter lives in
        # profiling.set_profiling_enabled
        self.profiling = os.environ.get("TM_TPU_PROFILING", "") == "1"


OBS = _ObsState()


def set_telemetry_enabled(flag: bool) -> None:
    """Runtime kill switch for the whole telemetry layer.

    Disabling stops all counting, latency sampling, profiler annotations,
    and event-bus publishing; already-collected telemetry stays readable
    (``Metric.telemetry_report()``, registry exports).
    """
    OBS.enabled = bool(flag)


def telemetry_enabled() -> bool:
    return OBS.enabled


def set_telemetry_sampling(every: int) -> None:
    """Take one latency sample per ``every`` instrumented calls (default 16).

    Counters are exact regardless; sampling only bounds the
    ``perf_counter`` overhead on hot paths and the reservoir churn.
    """
    if not (isinstance(every, int) and every >= 1):
        raise ValueError(f"`every` must be a positive integer, got {every!r}")
    OBS.sample_every = every
