"""Deterministic fault injection for the metric runtime.

Port of ``torchmetrics_tpu/_resilience/faultinject.py``: the same injectors
under the same names. Tensors stay where they are: a poisoned batch or a
corrupted checkpoint state is made on the tensor's own device.

Everything here is a context manager (or pure helper) that perturbs exactly
one seam and restores it on exit:

- :func:`simulated_world` — make one process look like an ``N``-process world:
  ``distributed_available()`` flips true and the eager transport returns
  ``N`` stacked copies of the local value (every simulated process
  contributing identical data). All other injectors compose inside it.
- :func:`inject_collective_failure` — the first ``first_n`` transport calls
  raise, then the underlying transport resumes: exercises retry + backoff.
- :func:`inject_collective_timeout` — the first ``first_n`` transport calls
  block (bounded by ``hang`` seconds and released at context exit, so a test
  can never truly deadlock): exercises the watchdog + degradation path.
- :func:`corrupt_state_dict` / :func:`poison_nans` — deterministic
  checkpoint corruption and NaN batch poisoning.
- :func:`nan_batches` — poison selected ``update()`` calls of one metric.

The injectors patch module-level seams in
``torchmetrics_tpu_torch.utilities.distributed`` (``_transport`` /
``_world_override``) — the same indirection the real ``torch.distributed``
transport flows through, so the production code path under test is the one
that runs on a real NCCL or gloo world.
"""

from __future__ import annotations

import copy
import functools
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from torchmetrics_tpu_torch._resilience.integrity import HostBF16, _floating, _numel, from_host, to_host
from torchmetrics_tpu_torch.utilities import distributed as _dist

__all__ = [
    "InjectionStats",
    "simulated_world",
    "inject_collective_failure",
    "inject_collective_timeout",
    "corrupt_state_dict",
    "corrupt_file",
    "poison_nans",
    "nan_batches",
]


@dataclass
class InjectionStats:
    """Live counters yielded by the injectors (assertable mid-context)."""

    calls: int = 0  # transport invocations observed
    injected: int = 0  # invocations that were perturbed


def _current_transport() -> Callable[[Any], Any]:
    return _dist._transport if _dist._transport is not None else _dist._default_transport


@contextmanager
def simulated_world(size: int = 2, transport: Optional[Callable[[Any], Any]] = None) -> Iterator[None]:
    """Simulate an ``size``-process world on a single host.

    The default transport stacks ``size`` copies of the local value along a
    new leading axis — exactly the shape contract of
    :func:`~torchmetrics_tpu_torch.utilities.distributed.process_allgather` — so every simulated process
    contributes identical data and sum-reduced states come back multiplied
    by the world size. Pass ``transport`` to model per-process divergence.
    """
    if size < 1:
        raise ValueError(f"simulated world size must be >= 1, got {size}")

    def _stack(v: Any) -> Any:
        if isinstance(v, torch.Tensor):
            return torch.stack([v] * size)
        return np.stack([np.asarray(v)] * size)

    def _stack_world(x: Any) -> Any:
        return _dist._tree_map(_stack, x)

    prev = (_dist._world_override, _dist._transport)
    _dist._world_override = size
    _dist._transport = transport if transport is not None else _stack_world
    try:
        yield
    finally:
        _dist._world_override, _dist._transport = prev


@contextmanager
def inject_collective_failure(
    first_n: int = 1, exc_factory: Optional[Callable[[], BaseException]] = None
) -> Iterator[InjectionStats]:
    """Fail the first ``first_n`` transport calls with a transient error."""
    inner = _current_transport()
    stats = InjectionStats()

    def patched(x: Any) -> Any:
        stats.calls += 1
        if stats.injected < first_n:
            stats.injected += 1
            if exc_factory is not None:
                raise exc_factory()
            raise ConnectionError(
                f"injected collective failure ({stats.injected}/{first_n}): simulated transport fault"
            )
        return inner(x)

    prev = _dist._transport
    _dist._transport = patched
    try:
        yield stats
    finally:
        _dist._transport = prev


@contextmanager
def inject_collective_timeout(first_n: int = 1, hang: float = 60.0) -> Iterator[InjectionStats]:
    """Stall the first ``first_n`` transport calls (a hung peer / dead link).

    Each stalled call blocks up to ``hang`` seconds on an event that context
    exit sets, so abandoned watchdog workers wake and die promptly instead of
    sleeping out the full duration; a stalled call that wakes raises
    ``TimeoutError`` rather than returning garbage.
    """
    inner = _current_transport()
    stats = InjectionStats()
    release = threading.Event()

    def patched(x: Any) -> Any:
        stats.calls += 1
        if stats.injected < first_n:
            stats.injected += 1
            release.wait(hang)
            raise TimeoutError(f"injected collective stall ({stats.injected}/{first_n}) released")
        return inner(x)

    prev = _dist._transport
    _dist._transport = patched
    try:
        yield stats
    finally:
        release.set()
        _dist._transport = prev


# ---------------------------------------------------------------------------
# checkpoint + batch corruption
# ---------------------------------------------------------------------------


def _first_matching_key(state_dict: Dict[str, Any], floating_only: bool) -> str:
    for key in sorted(state_dict):
        if key.endswith("#integrity"):
            continue
        for arr in _as_arrays(state_dict[key]):
            if _numel(arr) and (not floating_only or _floating(arr)):
                return key
    raise ValueError("state_dict has no corruptible array state")


def _as_arrays(value: Any) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value]


def _copy(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, HostBF16):
        return HostBF16(v.words.copy())
    return np.array(v, copy=True)


def corrupt_state_dict(
    state_dict: Dict[str, Any], key: Optional[str] = None, mode: str = "bitflip", seed: int = 0
) -> Dict[str, Any]:
    """Deterministically corrupted deep copy of a checkpoint.

    ``mode="bitflip"`` inverts one byte in the middle of the state's buffer
    (a storage/transfer fault); ``mode="nan"`` overwrites a deterministic
    third of a floating state with NaN (a poisoned-accumulator fault). The
    integrity block, if present, is left untouched — that is the point: the
    checksums no longer match the payload. Tensors are copied on their own
    device; the corrupted one makes one round trip through the host.
    """
    if mode not in ("bitflip", "nan"):
        raise ValueError(f"unknown corruption mode {mode!r}; expected 'bitflip' or 'nan'")
    out = {
        k: (
            [_copy(x) for x in v]
            if isinstance(v, (list, tuple))
            else copy.deepcopy(v) if isinstance(v, dict) else _copy(v)
        )
        for k, v in state_dict.items()
    }
    if key is None:
        key = _first_matching_key(out, floating_only=(mode == "nan"))
    value = out[key]
    target = value[0] if isinstance(value, list) else value
    device = target.device if isinstance(target, torch.Tensor) else None
    host = to_host(target) if device is not None else target
    host = host.words if isinstance(host, HostBF16) else np.asarray(host)
    rng = np.random.default_rng(seed)
    if mode == "bitflip":
        flat = np.ascontiguousarray(host)
        buf = flat.reshape(-1).view(np.uint8)
        pos = int(rng.integers(0, buf.size)) if buf.size > 1 else 0
        buf[pos] ^= 0xFF
        corrupted = flat.reshape(host.shape)
    else:
        if not _floating(target):
            raise ValueError(f"state {key!r} has dtype {target.dtype}; 'nan' mode needs a floating state")
        if isinstance(target, torch.Tensor):
            corrupted_t = target.clone(memory_format=torch.contiguous_format)
            corrupted_t.view(-1)[: max(1, corrupted_t.numel() // 3)] = float("nan")
            corrupted = corrupted_t
        else:
            corrupted = np.array(host, copy=True)
            cflat = corrupted.reshape(-1)
            cflat[: max(1, cflat.size // 3)] = np.nan
    if mode == "bitflip" and device is not None:
        if target.dtype == torch.bfloat16:
            corrupted = from_host(HostBF16(corrupted), device)
        else:
            corrupted = torch.from_numpy(corrupted).to(device)
    elif mode == "bitflip" and isinstance(target, HostBF16):
        corrupted = HostBF16(corrupted)
    if isinstance(value, list):
        value[0] = corrupted
    else:
        out[key] = corrupted
    return out


def corrupt_file(path: Any, mode: str = "bitflip", seed: int = 0) -> None:
    """Deterministically corrupt one on-disk file in place.

    ``mode="bitflip"`` inverts one byte at a seed-chosen offset past any
    header region (a storage fault the snapshot layer's file checksum must
    catch); ``mode="truncate"`` cuts the file at a seed-chosen point (a
    crash mid-write / torn journal tail). Backs the chaos harness's
    corrupted-generation and truncated-journal faults.
    """
    import pathlib

    if mode not in ("bitflip", "truncate"):
        raise ValueError(f"unknown file corruption mode {mode!r}; expected 'bitflip' or 'truncate'")
    p = pathlib.Path(path)
    raw = bytearray(p.read_bytes())
    if not raw:
        return
    rng = np.random.default_rng(seed)
    if mode == "bitflip":
        # skip the first 8 bytes so a magic-prefix check alone can't mask a
        # payload corruption — the checksum must do the catching
        lo = min(8, len(raw) - 1)
        pos = int(rng.integers(lo, len(raw)))
        raw[pos] ^= 0xFF
        p.write_bytes(bytes(raw))
    else:
        cut = int(rng.integers(1, len(raw))) if len(raw) > 1 else 0
        p.write_bytes(bytes(raw[:cut]))


def poison_nans(array: Any, frac: float = 0.5) -> Any:
    """Deterministic NaN-poisoned copy of a floating array (its first ``frac`` elements).

    A tensor is poisoned on its own device and comes back a tensor; a numpy
    array comes back a CPU tensor.
    """
    t = torch.as_tensor(array)
    if not t.is_floating_point():
        raise ValueError(f"poison_nans needs a floating array, got dtype {t.dtype}")
    out = t.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    flat[: max(1, int(flat.numel() * frac))] = float("nan")
    return out


@contextmanager
def nan_batches(metric: Any, indices: Sequence[int] = (0,), frac: float = 0.5) -> Iterator[InjectionStats]:
    """Poison the first floating array argument of selected ``update()`` calls.

    ``indices`` are 0-based positions in the stream of ``update`` calls made
    while the context is active — ``indices=(2,)`` poisons only the third
    batch, deterministically.
    """
    stats = InjectionStats()
    wanted = set(int(i) for i in indices)
    orig_update = metric.update

    @functools.wraps(orig_update)
    def patched(*args: Any, **kwargs: Any) -> Any:
        idx, stats.calls = stats.calls, stats.calls + 1
        if idx in wanted:
            stats.injected += 1
            args = _poison_first_float(args, frac)
        return orig_update(*args, **kwargs)

    metric.update = patched
    try:
        yield stats
    finally:
        metric.update = orig_update


def _poison_first_float(args: tuple, frac: float) -> tuple:
    out = list(args)
    for i, a in enumerate(out):
        if isinstance(a, (torch.Tensor, np.ndarray)) and _floating(a):
            out[i] = poison_nans(a, frac)
            return tuple(out)
    raise ValueError("nan_batches found no floating array argument to poison")
