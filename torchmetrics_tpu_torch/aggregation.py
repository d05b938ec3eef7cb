"""Aggregation primitives: Max/Min/Sum/Cat/Mean and their running forms.

Port of ``torchmetrics_tpu/aggregation.py`` (parity target: reference
``torchmetrics/aggregation.py``). ``nan_strategy`` keeps the JAX package's
eager behaviour: ``"error"`` raises, ``"warn"`` warns and drops the NaN
elements, ``"ignore"`` drops them, ``"disable"`` passes them through and a
float replaces them. Finding a NaN reads one flag back to the host per eager
update, as the eager JAX path does. Inside a compiled step the strategy runs
with no read back: a NaN becomes the reduction's neutral value with weight
zero, which reduces as dropping it does, and the raise or the warning rides
the fused flag vector (:meth:`BaseAggregator._traced_value_flags`). So the
default aggregators (``nan_strategy="warn"``) compile. ``CatMetric`` would
keep the neutral rows, so its NaN filtering stays eager.

``MeanMetric`` keeps (weighted sum, weight sum), both ``sum`` states, so its
distributed merge is one reduction each.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _in_compiled_step
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer

__all__ = [
    "BaseAggregator",
    "MaxMetric",
    "MinMetric",
    "SumMetric",
    "CatMetric",
    "MeanMetric",
    "RunningMean",
    "RunningSum",
]


class BaseAggregator(Metric):
    """Base class for aggregation metrics (reference ``aggregation.py:30-113``)."""

    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False

    # what a NaN becomes inside a compiled step: no change to the reduction
    # (0 for sum and mean; Max/Min override with -inf/+inf)
    _nan_neutral: float = 0.0
    # CatMetric appends rows, so a neutral row would be kept: it stays eager
    _nan_imputation_traceable: bool = True

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore", "disable")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy}"
                f" but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        # the raise and warn strategies carry a per-batch value check: it
        # opts the compiled path into the fused flags (JAX ``aggregation.py:89``)
        self.validate_args = nan_strategy in ("error", "warn")
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)
        self.state_name = state_name

    def _traced_value_flags(
        self, value: Union[float, Tensor], weight: Optional[Union[float, Tensor]] = None
    ) -> Tuple[Tuple[str, ...], Tensor, Tuple[str, ...]]:
        """The NaN check on the device, one flag of the strategy's severity (JAX ``aggregation.py:91``)."""
        bad = torch.isnan(torch.as_tensor(value, dtype=torch.float32, device=self.device)).any()
        if isinstance(weight, Tensor):
            bad = bad | torch.isnan(weight.to(torch.float32)).any()
        if self.nan_strategy == "error":
            return ("Encountered `nan` values in tensor",), bad.reshape(1), ("error",)
        return ("Encountered `nan` values in tensor. Will be removed.",), bad.reshape(1), ("warn",)

    def _cast_and_nan_check_input(
        self, x: Union[float, Tensor], weight: Optional[Union[float, Tensor]] = None
    ) -> Tuple[Tensor, Tensor]:
        """Float32 values and weights on the metric's device, with the NaN strategy applied."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        weight_was_scalar = weight is None or torch.as_tensor(weight).ndim == 0
        if weight is None:
            weight = torch.ones_like(x)
        elif isinstance(weight, Tensor):
            weight = weight.to(device=self.device, dtype=torch.float32)
        else:  # a fill, not a host-to-device copy, so a graph can capture it
            weight = torch.full((), float(weight), dtype=torch.float32, device=self.device)
        weight = torch.broadcast_to(weight, x.shape)

        if self.nan_strategy == "disable":
            return x, weight
        nans = torch.isnan(x) | torch.isnan(weight)
        if _in_compiled_step():
            return self._impute_nans(x, weight, nans, weight_was_scalar)
        any_nan = bool(nans.any())
        if any_nan and self.nan_strategy == "error":
            raise RuntimeError("Encountered `nan` values in tensor")
        if self.nan_strategy in ("ignore", "warn"):
            if not any_nan:
                return x, weight
            if self.nan_strategy == "warn":
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
            keep = ~nans.reshape(-1)
            return x.reshape(-1)[keep], weight.reshape(-1)[keep]
        if not isinstance(self.nan_strategy, float):  # "error" on a batch without NaN
            return x, weight
        x = torch.where(nans, self.nan_strategy, x)
        if weight_was_scalar:
            # reference parity quirk (JAX aggregation.py:147-158): the reference
            # broadcasts a scalar weight before its NaN check, so its in-place
            # `weight[nans] = value` writes through the 0-stride view and EVERY
            # weight becomes the replacement value, on a batch that has NaNs
            weight = torch.full_like(weight, self.nan_strategy) if any_nan else weight
        else:
            weight = torch.where(nans, self.nan_strategy, weight)
        return x, weight

    def _impute_nans(self, x: Tensor, weight: Tensor, nans: Tensor, weight_was_scalar: bool) -> Tuple[Tensor, Tensor]:
        """The NaN strategy with no read back (JAX ``aggregation.py:128-172``)."""
        if self.nan_strategy in ("error", "warn", "ignore"):
            if not self._nan_imputation_traceable:
                raise TorchMetricsUserError(
                    f"{type(self).__name__} keeps dropped elements out of an append-mode state;"
                    " its NaN filtering is value-dependent and cannot run in a compiled step"
                )
            if self.nan_strategy == "error" and not self.__dict__.get("_fused_flags_tracing"):
                # a step without the fused flags (jit_update, scan_update) can
                # neither raise nor drop a NaN batch
                raise TorchMetricsUserError(
                    f"{type(self).__name__}(nan_strategy='error') cannot run in a compiled step without"
                    " the fused violation flags (plain `update()` compiles them; `jit_update`/"
                    "`scan_update` skip validation): use nan_strategy='ignore'/'disable' or the"
                    " plain update path"
                )
            return torch.where(nans, self._nan_neutral, x), torch.where(nans, 0.0, weight)
        x = torch.where(nans, self.nan_strategy, x)
        if weight_was_scalar:
            # the reference's quirk (see the eager path), chosen on the device
            weight = torch.where(nans.any(), torch.full_like(weight, self.nan_strategy), weight)
        else:
            weight = torch.where(nans, self.nan_strategy, weight)
        return x, weight

    def update(self, value: Union[float, Tensor]) -> None:
        """Overwrite in child class."""

    def compute(self) -> Tensor:
        return getattr(self, self.state_name)


class MaxMetric(BaseAggregator):
    """Running maximum of a stream of values (reference ``aggregation.py:114``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(3.)
    """

    full_state_update = True
    _nan_neutral = -float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = torch.maximum(self.value, value.max())


class MinMetric(BaseAggregator):
    """Running minimum of a stream of values (reference ``aggregation.py:219``)."""

    full_state_update = True
    _nan_neutral = float("inf")

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = torch.minimum(self.value, value.min())


class SumMetric(BaseAggregator):
    """Running sum of a stream of values (reference ``aggregation.py:324``)."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value += value.sum()


class CatMetric(BaseAggregator):
    """Concatenate a stream of values (reference ``aggregation.py:429``).

    With ``cat_state_capacity`` the values go into a ring buffer, and
    ``compute`` returns its live rows as one tensor.
    """

    _nan_imputation_traceable = False

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value, _ = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> Tensor:
        if isinstance(self.value, (list, RingBuffer)) and len(self.value):
            return dim_zero_cat(self.value)
        return self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean of a stream of values (reference ``aggregation.py:493``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> metric.compute()
        tensor(2.)
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value, weight = self._cast_and_nan_check_input(value, weight)
        if value.numel() == 0:
            return
        self.value += (value * weight).sum()
        self.weight += weight.sum()

    def compute(self) -> Tensor:
        # raw division (reference aggregation.py:573): zero total weight, as
        # after the nan_strategy=0.0 scalar-weight quirk, gives nan
        return self.value / self.weight


def _make_running(name: str, base_cls: type, doc: str) -> type:
    from torchmetrics_tpu_torch.wrappers.running import Running

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        Running.__init__(self, base_cls(nan_strategy=nan_strategy, **kwargs), window=window)

    cls = type(name, (Running,), {"__init__": __init__, "__doc__": doc})
    cls.__module__ = __name__  # the generated class pickles by this module's path
    cls.__qualname__ = name
    return cls


RunningMean = _make_running(
    "RunningMean", MeanMetric, "Mean over the last ``window`` updates (reference ``aggregation.py:616``)."
)
RunningSum = _make_running(
    "RunningSum", SumMetric, "Sum over the last ``window`` updates (reference ``aggregation.py:673``)."
)
