"""BootStrapper (port of ``torchmetrics_tpu/wrappers/bootstrapping.py``).

Two routes, entered under the JAX package's conditions:

- **the per-copy loop** (the reference's): each of the ``N`` copies of the
  base metric is updated on its own resample of the batch, whose indices come
  from numpy's ``default_rng(seed)``, so both packages draw the same indices
  from the same seed. It runs the first batch of a stream, every batch of a
  metric that validates its arguments (``validate_args=True``), and every
  batch after the stacked route has been switched off;
- **the stacked route**: the copies' states live as ``(N, ...)`` stacks. Each
  batch's per-sample state deltas come from ``torch.func.vmap`` over a pure
  form of the base update (states in, states out); the ``N`` resample count
  vectors, drawn from a ``torch.Generator`` seeded from ``seed``
  (``torch.poisson`` of ones, or ``randint`` and ``scatter_add_`` for the
  multinomial strategy), are applied as one ``(N, B) @ (B, S)`` float32
  product in full float32. This is exact where the update adds up over
  samples into sum-reduced states of fixed shape, which an additivity check
  (the full batch's delta against the sum of the per-sample ones, once per
  batch size) verifies before a batch size is first taken. A failed check,
  or an update that cannot run under ``vmap`` (a host read such as
  ``.item()``, control flow on a value, or an op without a batching rule
  such as ``torch.bincount``, whose per-sample fallback is turned into an
  error here), switches the wrapper to the loop for good. A batch whose
  per-sample deltas would take more than ``_STACKED_DELTA_BYTES`` (in the
  states' dtypes and again in float32) takes the loop too, that batch only:
  a 1000-class confusion matrix holds 8 MB of them a sample, 8 GB at a
  batch of 1024, where the loop's ``N`` updates cost less.

``route_counts`` says how many updates each route took. The stacked route's
draws are not ``jax.random``'s; its counts have the same law.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _no_vmap_fallback
from torchmetrics_tpu_torch.utilities.compute import full_fp32
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


# the most bytes of per-sample deltas the stacked route materialises for one batch; past it the loop's N updates
# are the faster route: over a 1000-class confusion matrix on an H100 the stacked route wins at a batch of 256
# (1.9 GB of deltas) and loses at 1,024 (7.6 GB; chip_smoke.py phase 43, PERF.md)
_STACKED_DELTA_BYTES = 1 << 31


def _bootstrap_sampler(size: int, sampling_strategy: str, rng: np.random.Generator) -> np.ndarray:
    """Resampling indices for one bootstrap copy (JAX ``bootstrapping.py:40``)."""
    if sampling_strategy == "poisson":
        p = rng.poisson(1, size)
        return np.repeat(np.arange(size), p)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size)
    raise ValueError("Unknown sampling strategy")


def _split_batch(args: tuple, kwargs: Dict[str, Any]) -> Tuple[List[Tensor], List[Tuple[str, Any]]]:
    """The batched leaves (tensors with a leading axis) of an update's arguments, and where each sits."""
    leaves, slots = [], []
    for i, a in enumerate(args):
        if isinstance(a, Tensor) and a.ndim > 0:
            leaves.append(a)
            slots.append(("arg", i))
    for k, v in kwargs.items():
        if isinstance(v, Tensor) and v.ndim > 0:
            leaves.append(v)
            slots.append(("kw", k))
    return leaves, slots


def _merge_batch(args: tuple, kwargs: Dict[str, Any], slots: List[Tuple[str, Any]], leaves) -> Tuple[list, dict]:
    new_args, new_kwargs = list(args), dict(kwargs)
    for (kind, where), leaf in zip(slots, leaves):
        if kind == "arg":
            new_args[where] = leaf
        else:
            new_kwargs[where] = leaf
    return new_args, new_kwargs


class BootStrapper(WrapperMetric):
    """Bootstrap-resampled uncertainty estimates for any metric.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = BootStrapper(MulticlassAccuracy(num_classes=3, device="cpu"), num_bootstraps=5, seed=0)
        >>> metric.update(torch.tensor([0, 1, 2, 0]), torch.tensor([0, 1, 1, 0]))
        >>> sorted(metric.compute().keys())
        ['mean', 'std']
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_bootstraps)])
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.default_rng(seed)
        # seed=None draws the stacked route's seed from the loop's rng first, as the JAX package draws its key
        stacked_seed = seed if seed is not None else int(self._rng.integers(2**31))
        self._generator = torch.Generator(device=self.device).manual_seed(stacked_seed)
        self._stacked: Optional[Dict[str, Tensor]] = None  # name -> (N, ...) states of the stacked route
        self._stacked_pending = 0  # stacked updates not yet folded into self.metrics
        self._fast_disabled = False
        self._fast_checked_sizes: set = set()  # batch sizes whose additivity check passed
        self._loop_warmed = False  # a stream's first batch runs the loop (the copies validate eagerly)
        self._route_counts = {"loop": 0, "stacked": 0}

    @property
    def route_counts(self) -> Dict[str, int]:
        """How many updates took each route (``"loop"``, ``"stacked"``) since the last reset."""
        return self._route_counts

    # ---------------------------------------------------------- stacked route
    def _fast_names(self) -> Optional[List[str]]:
        """The base metric's state names if all are sum-reduced tensors of fixed shape, else None."""
        template = self.metrics[0]
        if getattr(template, "validate_args", None) is True:
            # value checks run eagerly on concrete data; the stacked route needs validate_args=False
            return None
        names = list(template._defaults)
        for n in names:
            default = template._defaults[n]
            if not isinstance(default, Tensor) or template._reductions[n] != "sum":
                return None
            if any(getattr(m, n).shape != default.shape for m in self.metrics):
                return None
        return names or None

    @staticmethod
    def _pure_update(template: Metric, names: List[str], states: Dict[str, Tensor], args, kwargs) -> Dict[str, Tensor]:
        """The base update as a function of its states: ``states`` in, the updated states out; ``template`` unchanged."""
        saved = {n: getattr(template, n) for n in names}
        try:
            for n in names:
                setattr(template, n, states[n])
            type(template).update(template, *args, **kwargs)  # the class's update, without the counting wrapper
            return {n: getattr(template, n) for n in names}
        finally:
            for n, value in saved.items():
                setattr(template, n, value)

    def _delta_bytes(self, names: List[str], size: int) -> int:
        """Bytes of a batch's per-sample deltas: each state ``size`` times in its dtype and again in float32."""
        defaults = self.metrics[0]._defaults
        return size * sum(defaults[n].numel() * (defaults[n].element_size() + 4) for n in names)

    def _zeros(self, names: List[str], lead: Tuple[int, ...] = ()) -> Dict[str, Tensor]:
        defaults = self.metrics[0]._defaults
        return {n: torch.zeros(lead + tuple(defaults[n].shape), dtype=defaults[n].dtype, device=defaults[n].device)
                for n in names}

    def _per_sample_deltas(self, names, args, kwargs, leaves, slots, size: int) -> Dict[str, Tensor]:
        template = self.metrics[0]

        def one_sample(zeros, *sample):
            a, kw = _merge_batch(args, kwargs, slots, [leaf.unsqueeze(0) for leaf in sample])
            return self._pure_update(template, names, zeros, a, kw)

        # the zero states enter batched, so the update's in-place adds write into per-sample states
        with _no_vmap_fallback():
            return torch.func.vmap(one_sample)(self._zeros(names, (size,)), *leaves)

    def _additivity_holds(self, names, args, kwargs, deltas: Dict[str, Tensor]) -> bool:
        """The full batch's state delta equals the sum of the per-sample deltas (JAX ``bootstrapping.py:137``)."""
        full = self._pure_update(self.metrics[0], names, self._zeros(names), args, kwargs)
        for n in names:
            a = full[n].to(torch.float64)
            b = deltas[n].to(torch.float32).sum(dim=0).to(torch.float64)
            if not torch.allclose(a, b, rtol=1e-3, atol=1e-5):
                return False
        return True

    def _draw_counts(self, size: int) -> Tensor:
        """``(N, size)`` float32 resample counts: how often each copy takes each sample."""
        shape, dev = (self.num_bootstraps, size), self._generator.device
        if self.sampling_strategy == "poisson":
            return torch.poisson(torch.ones(shape, device=dev), generator=self._generator)
        draws = torch.randint(0, size, shape, generator=self._generator, device=dev)
        return torch.zeros(shape, device=dev).scatter_add_(1, draws, torch.ones(shape, device=dev))

    def _try_fast_update(self, args: tuple, kwargs: Dict[str, Any]) -> bool:
        if self._fast_disabled:
            return False
        if not self._loop_warmed:
            self._loop_warmed = True
            return False
        names = self._fast_names()
        leaves, slots = _split_batch(args, kwargs)
        sizes = {leaf.shape[0] for leaf in leaves}
        if names is None or len(sizes) != 1:
            self._fast_disabled = True
            return False
        size = sizes.pop()
        if self._delta_bytes(names, size) > _STACKED_DELTA_BYTES:
            return False  # this batch's per-sample deltas outweigh the loop
        if size == 1 and not self._fast_checked_sizes:
            # a single sample passes the additivity check for any metric, yet scaling its delta by a count k
            # equals k repeated samples only for an additive update: size-1 batches never license the route
            return False
        try:
            deltas = self._per_sample_deltas(names, args, kwargs, leaves, slots, size)
            if size > 1 and size not in self._fast_checked_sizes:
                if not self._additivity_holds(names, args, kwargs, deltas):
                    self._fast_disabled = True
                    return False
                self._fast_checked_sizes.add(size)
        except Exception:  # noqa: BLE001 - an update that cannot run under vmap takes the loop, which re-raises real faults
            self._fast_disabled = True
            return False
        if self._stacked is None:
            self._stacked = {n: torch.stack([getattr(m, n) for m in self.metrics]) for n in names}
        counts = self._draw_counts(size)
        for n in names:
            flat = deltas[n].to(torch.float32).reshape(size, -1)
            with full_fp32():
                upd = counts.to(flat.device) @ flat
            stacked = self._stacked[n]
            stacked += upd.reshape(stacked.shape).to(stacked.dtype)
        self._stacked_pending += 1
        return True

    def _materialize(self) -> None:
        """Fold the stacked states back into the per-copy metrics."""
        if self._stacked is None:
            return
        stacked, self._stacked = self._stacked, None
        pending, self._stacked_pending = self._stacked_pending, 0
        for idx, metric in enumerate(self.metrics):
            for name, value in stacked.items():
                setattr(metric, name, value[idx].clone())
            metric._update_count += pending
            metric._computed = None

    # -------------------------------------------------------------------- api
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch for each bootstrap copy and update the copies, by the stacked route where it holds."""
        if self._try_fast_update(args, kwargs):
            self._route_counts["stacked"] += 1
            return
        self._materialize()
        args_sizes = [a.shape[0] for a in args if isinstance(a, Tensor) and a.ndim > 0]
        kwargs_sizes = [v.shape[0] for v in kwargs.values() if isinstance(v, Tensor) and v.ndim > 0]
        if args_sizes:
            size = args_sizes[0]
        elif kwargs_sizes:
            size = kwargs_sizes[0]
        else:
            raise ValueError("None of the input contained any tensor, so no sampling could be done")
        for idx in range(self.num_bootstraps):
            sample_idx = _bootstrap_sampler(size, self.sampling_strategy, self._rng)
            if sample_idx.size == 0:
                continue
            index = torch.from_numpy(sample_idx)

            def take(v: Any) -> Any:
                return v[index.to(v.device)] if isinstance(v, Tensor) and v.ndim > 0 else v

            self.metrics[idx].update(*[take(a) for a in args], **{k: take(v) for k, v in kwargs.items()})
        self._route_counts["loop"] += 1

    def compute(self) -> Dict[str, Tensor]:
        """Mean, std, quantile and raw values over the bootstrap copies."""
        self._materialize()
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        # integer values (e.g. a confusion matrix's counts) average in float32, as jnp.mean promotes them
        stats = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
        output: Dict[str, Tensor] = {}
        if self.mean:
            output["mean"] = stats.mean(dim=0)
        if self.std:
            output["std"] = stats.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=stats.dtype, device=stats.device)
            output["quantile"] = torch.quantile(stats, q, dim=0)
        if self.raw:
            output["raw"] = computed_vals
        return output

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        self._stacked = None
        self._stacked_pending = 0
        self._loop_warmed = False  # the next stream's first batch runs the loop again
        self._route_counts = {"loop": 0, "stacked": 0}
        for m in self.metrics:
            m.reset()
        super().reset()

    # ------------------------------------------------------------ persistence
    def __getstate__(self) -> Dict[str, Any]:
        self._materialize()
        state = super().__getstate__()
        state["_stacked"] = None
        # the generator's state rides along, so a pickled seeded run resumes the stream it would have drawn
        state["_generator"] = self._generator.get_state()
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        generator_state = state.pop("_generator")
        super().__setstate__(state)
        self._generator = torch.Generator(device=self.device)
        self._generator.set_state(generator_state)
