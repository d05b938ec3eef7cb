"""Hardware ceilings + counted step costs for the profiling layer.

Port of ``torchmetrics_tpu/_observability/costs.py``. The roofline model
needs two kinds of numbers:

- **What a step does**: flops and bytes. The JAX package reads them from
  XLA's ``compiled.cost_analysis()``. A CUDA graph has no such analysis, so
  the port counts a step while it runs eagerly, once, before its capture
  (the warm-up, or a CPU metric's first run of the step): library ops
  through ``torch.utils.flop_counter.FlopCounterMode``, the hand-written
  kernels through their own ``*_cost`` functions (each wrapper reports its
  launch to :func:`tally_kernel` while a count is open), and bytes as the
  step's inputs, states and outputs (:func:`count_costs`). Where nothing can
  be counted the cost is absent, as in the JAX package when
  ``cost_analysis()`` gives nothing. :func:`extract_cost` keeps the JAX
  package's normalization of a ``cost_analysis()`` result for objects that
  offer one.
- **What the hardware could do**: peak flops and HBM bandwidth, the
  denominators of the MFU and roofline gauges. :func:`get_ceilings`
  resolves them in priority order: env overrides (``TM_TPU_PEAK_FLOPS``,
  ``TM_TPU_HBM_BW``), a measured-ceilings JSON named by
  ``TM_TPU_CEILINGS_JSON``, then the card's datasheet figures below. The
  port ships no measured-ceilings file.

With cost and ceilings in hand the gauges are closed-form::

    mfu      = flops / (seconds * peak_flops)
    ceiling  = min(1, arithmetic_intensity * hbm_bw / peak_flops)

where ``arithmetic_intensity = flops / bytes_accessed``.

The ceilings part stays import-light (no torch, no numpy): the ledger
imports it at module scope. :func:`count_costs` imports torch when called.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "ExecutableCost",
    "Ceilings",
    "CostTally",
    "add_output_bytes",
    "count_costs",
    "extract_cost",
    "get_ceilings",
    "set_ceilings",
    "load_measured_ceilings",
    "tally_kernel",
    "tallying",
    "CEILINGS_PATH",
    "DEFAULT_PEAK_FLOPS",
    "DEFAULT_HBM_BYTES_PER_S",
]

# NVIDIA H100 SXM5 datasheet figures for the card the port runs on ("NVIDIA
# H100 80GB HBM3, 700.00 W" by `nvidia-smi --query-gpu=name,power.limit
# --format=csv,noheader`): dense bf16 tensor-core peak and HBM3 bandwidth,
# the figures chip_smoke.py's `bound_ms` uses
DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_HBM_BYTES_PER_S = 3.35e12

# no measured-ceilings file ships with the port; TM_TPU_CEILINGS_JSON may name one
CEILINGS_PATH: Optional[Path] = None
_CEILINGS_VERSION = 1


@dataclass(frozen=True)
class ExecutableCost:
    """Flops and bytes of ONE compiled step (a CUDA graph, or a CPU metric's step), or of one kernel call."""

    flops: float
    bytes_accessed: float

    @property
    def arithmetic_intensity(self) -> float:
        """Flops per byte of memory traffic (0 when bytes are unknown)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed > 0 else 0.0

    def roofline_ceiling(self, ceilings: "Ceilings") -> float:
        """Attainable MFU under the roofline: memory-bound steps cap below 1."""
        if self.bytes_accessed <= 0 or ceilings.peak_flops <= 0:
            return 1.0
        return min(1.0, self.arithmetic_intensity * ceilings.hbm_bytes_per_s / ceilings.peak_flops)

    def mfu(self, seconds: float, ceilings: "Ceilings") -> float:
        """Achieved fraction of absolute peak for one step of ``seconds``."""
        if seconds <= 0 or ceilings.peak_flops <= 0:
            return 0.0
        return self.flops / (seconds * ceilings.peak_flops)

    def to_json(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed}


@dataclass(frozen=True)
class Ceilings:
    """Hardware performance ceilings the gauges divide by."""

    peak_flops: float
    hbm_bytes_per_s: float
    source: str  # "env" | "measured:<path>" | "default"

    def to_json(self) -> Dict[str, Any]:
        return {
            "peak_flops": self.peak_flops,
            "hbm_bytes_per_s": self.hbm_bytes_per_s,
            "source": self.source,
        }


def extract_cost(compiled: Any) -> Optional[ExecutableCost]:
    """Normalize ``compiled.cost_analysis()`` into an :class:`ExecutableCost` (the JAX package's rule).

    Accepts the analysis as a dict or a one-element list of dicts, and
    returns ``None`` when the object offers no analysis, the call fails, or
    it claims nothing. The port's own steps are counted by :func:`count_costs`.
    """
    try:
        analysis = compiled.cost_analysis()
    except Exception:  # noqa: BLE001 - any failure degrades to no-cost
        return None
    if isinstance(analysis, (list, tuple)):
        analysis = analysis[0] if analysis else None
    if not isinstance(analysis, dict):
        return None
    try:
        flops = float(analysis.get("flops", 0.0) or 0.0)
        bytes_accessed = float(analysis.get("bytes accessed", 0.0) or 0.0)
    except (TypeError, ValueError):
        return None
    if flops <= 0.0 and bytes_accessed <= 0.0:
        return None
    return ExecutableCost(flops=flops, bytes_accessed=bytes_accessed)


# ---------------------------------------------------------------------------
# counted costs
# ---------------------------------------------------------------------------

# the tallies open on this thread, innermost last; a kernel wrapper adds its
# launch's cost to each of them
_TALLIES = threading.local()


class CostTally:
    """What one eager run of a step did: library flops, hand-written kernels' flops, the step's bytes."""

    __slots__ = ("library_flops", "kernel_flops", "step_bytes")

    def __init__(self) -> None:
        self.library_flops = 0.0
        self.kernel_flops = 0.0
        self.step_bytes = 0.0

    def cost(self) -> Optional[ExecutableCost]:
        """The step's :class:`ExecutableCost`; None where nothing was counted."""
        flops = self.library_flops + self.kernel_flops
        if flops <= 0.0 and self.step_bytes <= 0.0:
            return None
        return ExecutableCost(flops=flops, bytes_accessed=self.step_bytes)


def tallying() -> bool:
    """True while a :func:`count_costs` block is open on this thread (one attribute read)."""
    return bool(getattr(_TALLIES, "open", None))


def tally_kernel(cost: Any) -> None:
    """Add one hand-written kernel launch's flops (its ``*_cost``, an :class:`ExecutableCost`) to the open tallies.

    A step's bytes are its own inputs, states and outputs, not the sum of
    what its kernels move between them.
    """
    for tally in getattr(_TALLIES, "open", ()):
        tally.kernel_flops += float(cost.flops)


def _tensor_bytes(tree: Any) -> float:
    """Bytes of every tensor in a nested tuple/list/dict (ring buffers count their storage)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    data = getattr(tree, "data", None)
    if data is not None and not callable(data):
        return _tensor_bytes(data)
    return 0.0


@contextlib.contextmanager
def count_costs(inputs: Any = (), states: Any = ()) -> Iterator[CostTally]:
    """Count what the block runs: a :class:`CostTally` of its flops and the step's bytes.

    Library ops are counted by ``FlopCounterMode`` (matmuls, convolutions,
    attention), the hand-written kernels by their ``*_cost`` functions. The
    bytes are ``inputs`` read once and ``states`` read and written once;
    the caller adds the step's outputs with :func:`add_output_bytes`. Used
    once a step, before its capture.
    """
    from torch.utils.flop_counter import FlopCounterMode

    tally = CostTally()
    tally.step_bytes = _tensor_bytes(inputs) + 2.0 * _tensor_bytes(states)
    stack: List[CostTally] = _TALLIES.__dict__.setdefault("open", [])
    stack.append(tally)
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            yield tally
    finally:
        stack.remove(tally)
        tally.library_flops = float(counter.get_total_flops())


def add_output_bytes(tally: CostTally, outputs: Any) -> None:
    """Count a step's outputs (written once) into ``tally``."""
    tally.step_bytes += _tensor_bytes(outputs)


# ---------------------------------------------------------------------------
# ceilings
# ---------------------------------------------------------------------------


def load_measured_ceilings(path: Optional[Path] = None) -> Optional[Ceilings]:
    """Ceilings from a measured-ceilings JSON (``{"version": 1, "peak_flops": .., "hbm_bytes_per_s": ..}``).

    Returns ``None`` when no path is given, or the file is absent or
    unreadable: measured ceilings are an upgrade, never a requirement.
    """
    target = Path(path) if path is not None else CEILINGS_PATH
    if target is None:
        return None
    try:
        blob = json.loads(target.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    if not isinstance(blob, dict) or blob.get("version") != _CEILINGS_VERSION:
        return None
    try:
        return Ceilings(
            peak_flops=float(blob["peak_flops"]),
            hbm_bytes_per_s=float(blob["hbm_bytes_per_s"]),
            source=f"measured:{target.name}",
        )
    except (KeyError, TypeError, ValueError):
        return None


# process-wide resolved ceilings; a list so set_ceilings swaps atomically
# under the GIL without a lock (single small-object assignment)
_ACTIVE: list = []


def _resolve() -> Ceilings:
    env_peak = os.environ.get("TM_TPU_PEAK_FLOPS")
    env_bw = os.environ.get("TM_TPU_HBM_BW")
    if env_peak or env_bw:
        try:
            return Ceilings(
                peak_flops=float(env_peak) if env_peak else DEFAULT_PEAK_FLOPS,
                hbm_bytes_per_s=float(env_bw) if env_bw else DEFAULT_HBM_BYTES_PER_S,
                source="env",
            )
        except ValueError:
            pass  # malformed override falls through to measured/default
    measured_path = os.environ.get("TM_TPU_CEILINGS_JSON")
    measured = load_measured_ceilings(Path(measured_path) if measured_path else None)
    if measured is not None:
        return measured
    return Ceilings(
        peak_flops=DEFAULT_PEAK_FLOPS,
        hbm_bytes_per_s=DEFAULT_HBM_BYTES_PER_S,
        source="default",
    )


def get_ceilings() -> Ceilings:
    """The active hardware ceilings (env > measured JSON > the card's datasheet)."""
    if not _ACTIVE:
        _ACTIVE.append(_resolve())
    return _ACTIVE[0]


def set_ceilings(ceilings: Optional[Ceilings]) -> None:
    """Override the active ceilings (``None`` re-resolves from env/JSON)."""
    _ACTIVE.clear()
    if ceilings is not None:
        _ACTIVE.append(ceilings)
