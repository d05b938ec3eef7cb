"""Utility layer: safe math, data ops, distributed gather, checks, enums, state carry-over, ring buffers.

``__all__`` lists the JAX package's names but ``sync_in_jit`` (it belongs to
``_spmd``'s ``to_spmd``, not ported yet); ``normalize_logits_if_needed`` and
``state_from_jax`` are importable from here as well, outside that list.
"""

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, check_forward_full_state_property
from torchmetrics_tpu_torch.utilities.compute import (
    _auc_compute,
    _safe_divide,
    _safe_matmul,
    _safe_xlogy,
    interp,
    normalize_logits_if_needed,
)
from torchmetrics_tpu_torch.utilities.convert import state_from_jax
from torchmetrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from torchmetrics_tpu_torch.utilities.distributed import class_reduce, gather_all_tensors, reduce
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utilities.prints import rank_zero_debug, rank_zero_info, rank_zero_warn
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer, ring_push

__all__ = [
    "_check_same_shape",
    "check_forward_full_state_property",
    "_auc_compute",
    "_safe_divide",
    "_safe_matmul",
    "_safe_xlogy",
    "interp",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
    "to_categorical",
    "to_onehot",
    "class_reduce",
    "gather_all_tensors",
    "reduce",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
    "RingBuffer",
    "ring_push",
]
