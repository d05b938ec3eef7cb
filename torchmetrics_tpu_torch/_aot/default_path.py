"""The certified default path: the canonical out-of-the-box compile sweep (JAX ``_aot/default_path.py``).

One deterministic definition shared by the consumers that must not drift
apart:

- ``golden.py`` writes the port's golden compile-key manifest
  (``torchmetrics_tpu_torch/_compile_golden.json``) from this sweep
  (``python -m torchmetrics_tpu_torch._aot golden --write``);
- the recompile gate (``tests/test_torch_recompile_gate.py``) drives it again
  and fails when a change builds any key beyond the manifest, with the churn
  detector naming the differing component(s).

Every case constructs at ctor defaults (``validate_args=True`` wherever the
knob exists) on the device given, and feeds a fixed-seed batch drawn with
numpy from the JAX package's seed, so the batches equal the JAX package's
value for value (integer labels come out as int64, PyTorch's label type,
where the JAX package's are int32). The observed keys (argument structure,
static values, shapes, dtypes, devices, layouts, dtype policy) are stable
across processes.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["DEFAULT_PATH_CASES", "canonical_batch", "drive_default_path", "collect_compile_keys"]

_SEED = 1234
_N = 32


def _arrays(maker: str) -> Tuple[np.ndarray, ...]:
    rng = np.random.default_rng(_SEED)
    if maker == "bin":
        return rng.random(_N).astype(np.float32), rng.integers(0, 2, _N)
    if maker == "mc":
        p = rng.random((_N, 4)).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.integers(0, 4, _N)
    if maker == "ml":
        return rng.random((_N, 3)).astype(np.float32), rng.integers(0, 2, (_N, 3))
    if maker == "reg":
        return rng.standard_normal(_N).astype(np.float32), rng.standard_normal(_N).astype(np.float32)
    if maker == "reg_pos":
        return (rng.random(_N) + 0.1).astype(np.float32), (rng.random(_N) + 0.1).astype(np.float32)
    if maker == "probs2d":
        p = rng.random((_N, 5)).astype(np.float32)
        q = rng.random((_N, 5)).astype(np.float32)
        return p / p.sum(1, keepdims=True), q / q.sum(1, keepdims=True)
    if maker == "agg":
        return (rng.random(_N).astype(np.float32),)
    raise ValueError(f"unknown canonical batch maker {maker!r}")


def canonical_batch(name: str, device: Union[str, Any, None] = None) -> Tuple[Any, ...]:
    """The fixed-seed batch the certified sweep feeds class ``name``, on ``device`` (``cuda`` unless given)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    return tuple(torch.as_tensor(a, device=dev) for a in _arrays(DEFAULT_PATH_CASES[name][1]))


def _cases() -> Dict[str, Tuple[Callable[..., Any], str]]:
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import aggregation

    # the JAX package's cross-family slice: bounded (the gate drives it inside the tier-1 budget)
    # but wide enough that a recompile regression in any family trips it
    return {
        "MeanMetric": (lambda **kw: aggregation.MeanMetric(**kw), "agg"),
        "MaxMetric": (lambda **kw: aggregation.MaxMetric(**kw), "agg"),
        "BinaryStatScores": (lambda **kw: tm.BinaryStatScores(**kw), "bin"),
        "BinaryAccuracy": (lambda **kw: tm.BinaryAccuracy(**kw), "bin"),
        "BinaryF1Score": (lambda **kw: tm.BinaryF1Score(**kw), "bin"),
        "BinaryConfusionMatrix": (lambda **kw: tm.BinaryConfusionMatrix(**kw), "bin"),
        "MulticlassAccuracy": (lambda **kw: tm.MulticlassAccuracy(num_classes=4, **kw), "mc"),
        "MulticlassStatScores": (lambda **kw: tm.MulticlassStatScores(num_classes=4, **kw), "mc"),
        "MultilabelAccuracy": (lambda **kw: tm.MultilabelAccuracy(num_labels=3, **kw), "ml"),
        "MultilabelRankingLoss": (lambda **kw: tm.MultilabelRankingLoss(num_labels=3, **kw), "ml"),
        "MeanSquaredError": (lambda **kw: tm.MeanSquaredError(**kw), "reg"),
        "MeanAbsoluteError": (lambda **kw: tm.MeanAbsoluteError(**kw), "reg"),
        "R2Score": (lambda **kw: tm.R2Score(**kw), "reg"),
        "PearsonCorrCoef": (lambda **kw: tm.PearsonCorrCoef(**kw), "reg"),
        "KLDivergence": (lambda **kw: tm.KLDivergence(**kw), "probs2d"),
        "TweedieDevianceScore": (lambda **kw: tm.TweedieDevianceScore(**kw), "reg_pos"),
    }


class _LazyCases(dict):
    """Defer the metric-class imports until the sweep is used."""

    def _fill(self) -> None:
        if not dict.__len__(self):
            dict.update(self, _cases())

    def __getitem__(self, key):  # noqa: D105
        self._fill()
        return super().__getitem__(key)

    def __iter__(self):  # noqa: D105
        self._fill()
        return super().__iter__()

    def __len__(self):  # noqa: D105
        self._fill()
        return super().__len__()

    def keys(self):  # noqa: D102
        self._fill()
        return super().keys()

    def items(self):  # noqa: D102
        self._fill()
        return super().items()


DEFAULT_PATH_CASES: Dict[str, Tuple[Callable[..., Any], str]] = _LazyCases()


def collect_compile_keys(metric: Any) -> List[Dict[str, Any]]:
    """Every distinct compiled-path key this instance reported, from the recompile-churn detector's store."""
    telem = metric.__dict__.get("_telem")
    if telem is None:
        return []
    return [{"kind": kind, "components": dict(components)} for kind, components in sorted(telem._compile_keys)]


def drive_default_path(
    names: Optional[List[str]] = None,
    updates: int = 3,
    precompile: bool = False,
    device: Union[str, Any, None] = None,
) -> Dict[str, List[Dict[str, Any]]]:
    """Drive the certified default path on ``device`` (``cuda`` unless given); return each class's compile keys.

    Telemetry is forced on for the drive (the churn detector is the
    measuring instrument) and restored afterwards. Each class gets a fresh
    instance, ``updates`` repeat-signature updates (the first eager and
    registering the signature, the later ones compiled) and one
    ``compute()``. With ``precompile=True`` the sweep warms through
    ``Metric.precompile`` first, the deployment flow the AOT cache serves.
    """
    from torchmetrics_tpu_torch._observability.state import OBS

    cases = DEFAULT_PATH_CASES
    names = list(names) if names is not None else sorted(cases.keys())
    was_enabled = OBS.enabled
    OBS.enabled = True
    observed: Dict[str, List[Dict[str, Any]]] = {}
    try:
        for name in names:
            ctor, _maker = cases[name]
            metric = ctor(device=device or "cuda")
            args = canonical_batch(name, device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if precompile:
                    metric.precompile(*args)
                for _ in range(updates):
                    metric.update(*args)
                metric.compute()
            observed[name] = collect_compile_keys(metric)
    finally:
        OBS.enabled = was_enabled
    return observed
