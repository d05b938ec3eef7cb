"""Utility layer: safe math, data ops, distributed gather, checks, enums, state carry-over."""

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.convert import state_from_jax
from torchmetrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_onehot,
)
from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utilities.prints import rank_zero_debug, rank_zero_info, rank_zero_warn

__all__ = [
    "_check_same_shape",
    "_safe_divide",
    "normalize_logits_if_needed",
    "state_from_jax",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
    "to_onehot",
    "gather_all_tensors",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
]
