"""Permutation-invariant training (port of ``torchmetrics_tpu/functional/audio/pit.py``).

Speaker-wise, the pairwise matrix ``metric_mtx[b, t, p] = metric(preds[b, p],
target[b, t])`` comes from one call of ``metric_func`` on inputs broadcast
to ``(B, spk, spk, ...)``; an error of the metric propagates. Up to six
speakers every permutation is scored at once (``itertools.permutations``
order; ties go to the first, as ``argmax``/``argmin`` resolve them). Beyond
that the assignment is solved on the host, as the JAX package does with
scipy's ``linear_sum_assignment``, by this module's own O(n³) Hungarian
algorithm in numpy.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import Tensor

_MAX_EXHAUSTIVE_SPK = 6


@lru_cache(maxsize=None)
def _permutation_table(spk_num: int) -> np.ndarray:
    return np.asarray(list(permutations(range(spk_num))), dtype=np.int64)


def _gen_permutations(spk_num: int, device: torch.device) -> Tensor:
    return torch.from_numpy(_permutation_table(spk_num)).to(device)


def _best(metric_of_ps: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    if eval_func == "max":
        return torch.max(metric_of_ps, dim=1).values, torch.argmax(metric_of_ps, dim=1)
    return torch.min(metric_of_ps, dim=1).values, torch.argmin(metric_of_ps, dim=1)


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Score every permutation at once: a gather, a mean and an arg-reduce on the device."""
    spk_num = metric_mtx.shape[1]
    ps = _gen_permutations(spk_num, metric_mtx.device)  # [perm, spk]
    gathered = metric_mtx[:, torch.arange(spk_num, device=metric_mtx.device)[None, :], ps]  # [B, perm, spk]
    best_metric, best_indexes = _best(torch.mean(gathered, dim=-1), eval_func)
    return best_metric, ps[best_indexes, :]


def _hungarian(cost: np.ndarray) -> np.ndarray:
    """Column assigned to each row of a square ``cost`` matrix at the least total (the O(n³) potentials form)."""
    n = cost.shape[0]
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    match = np.zeros(n + 1, dtype=np.int64)  # match[j]: the row (1-based) held by column j; column 0 is the root
    way = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        match[0] = i
        j0 = 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = match[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            free = ~used[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            cand = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(cand)) + 1
            delta = cand[j1 - 1]
            u[match[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if match[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            match[j0] = match[j1]
            j0 = j1
    cols = np.empty(n, dtype=np.int64)
    cols[match[1:] - 1] = np.arange(n)
    return cols


def _linear_sum_assignment(matrix: np.ndarray, maximize: bool) -> np.ndarray:
    """The column of each row in an optimal assignment of a square matrix (scipy's ``[1]`` output)."""
    cost = -matrix if maximize else matrix
    return _hungarian(np.asarray(cost, dtype=np.float64))


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """The host's Hungarian algorithm for more than six speakers (one device-to-host copy and back)."""
    mmtx = metric_mtx.detach().cpu().numpy()
    perms = np.stack([_linear_sum_assignment(pwm, eval_func == "max") for pwm in mmtx])
    best_perm = torch.from_numpy(perms).to(metric_mtx.device)
    best_metric = torch.mean(torch.gather(metric_mtx, 2, best_perm[:, :, None]), dim=(-1, -2))
    return best_metric, best_perm


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """PIT: the best metric value over speaker permutations, and that permutation, per sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, mode="speaker-wise", eval_func="max")
        >>> best_perm.tolist()
        [[0, 1]]
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {target.shape} and {preds.shape} instead")

    batch_size, spk_num = target.shape[0:2]

    if mode == "permutation-wise":
        perms = _gen_permutations(spk_num, preds.device)  # [perm, spk]
        perm_num = perms.shape[0]
        ppreds = preds[:, perms.reshape(-1), ...].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = torch.repeat_interleave(target, perm_num, dim=0)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        best_metric, best_indexes = _best(torch.mean(metric_of_ps.reshape(batch_size, perm_num, -1), dim=-1), eval_func)
        return best_metric, perms[best_indexes, :]

    # speaker-wise: metric_mtx[b, t, p] = metric(preds[b, p], target[b, t]) from one broadcast call
    shape = (batch_size, spk_num, spk_num, *preds.shape[2:])
    p_b = preds[:, None].expand(shape)
    t_b = target[:, :, None].expand(shape)
    metric_mtx = metric_func(p_b, t_b, **kwargs)  # [B, spk_t, spk_p]
    if spk_num <= _MAX_EXHAUSTIVE_SPK:
        return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder the speakers of ``preds`` by the per-sample permutations that PIT returned."""
    index = perm.reshape(*perm.shape, *([1] * (preds.ndim - 2))).expand(*perm.shape, *preds.shape[2:])
    return torch.gather(preds, 1, index)
