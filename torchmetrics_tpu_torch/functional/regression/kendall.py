"""Kendall rank correlation (port of ``torchmetrics_tpu/functional/regression/kendall.py``).

Concordant, discordant and tied pairs are counted in int64 over row tiles
of the pairwise sign matrix, each tile at most ``_TILE_ELEMENTS`` pairs, so
no n x n matrix is built at once; the counts equal the JAX package's. Tau-c's
``m`` is the smaller count of distinct values. The p-value is the JAX
package's normal approximation with no tie correction.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.enums import EnumStr

_TILE_ELEMENTS = 1 << 24


class _MetricVariant(EnumStr):
    A = "a"
    B = "b"
    C = "c"

    @staticmethod
    def _name() -> str:
        return "variant"


class _TestAlternative(EnumStr):
    TWO_SIDED = "two-sided"
    LESS = "less"
    GREATER = "greater"

    @staticmethod
    def _name() -> str:
        return "alternative"


def _pair_counts(preds: Tensor, target: Tensor) -> Tensor:
    """int64 ``[concordant, discordant, ties in x only, ties in y only, ties in both]`` over pairs i < j."""
    n = preds.shape[0]
    counts = torch.zeros(5, dtype=torch.int64, device=preds.device)
    rows = max(1, _TILE_ELEMENTS // max(n, 1))
    cols = torch.arange(n, device=preds.device)
    for a in range(0, n, rows):
        b = min(n, a + rows)
        sx = torch.sign(preds[None, a:] - preds[a:b, None])  # [i, j] = sign(x_j - x_i), j from a on
        sy = torch.sign(target[None, a:] - target[a:b, None])
        upper = cols[None, a:] > cols[a:b, None]
        prod = sx * sy
        tx, ty = (sx == 0) & upper, (sy == 0) & upper
        counts += torch.stack([
            ((prod > 0) & upper).sum(), ((prod < 0) & upper).sum(),
            (tx & (sy != 0)).sum(), (ty & (sx != 0)).sum(), (tx & (sy == 0)).sum(),
        ])
    return counts


def _kendall_corrcoef_compute_single(preds: Tensor, target: Tensor, variant: str) -> Tuple[Tensor, Tensor]:
    """Tau of 1-D inputs, and ``concordant - discordant``."""
    n = preds.shape[0]
    con_i, dis_i, ties_x, ties_y, ties_xy = _pair_counts(preds, target)
    n_total = n * (n - 1) // 2
    con = con_i.to(torch.float32)
    dis = dis_i.to(torch.float32)
    if variant == "a":
        tau = (con - dis) / n_total
    elif variant == "b":
        tx = (ties_x + ties_xy).to(torch.float32)
        ty = (ties_y + ties_xy).to(torch.float32)
        tau = (con - dis) / torch.sqrt((n_total - tx) * (n_total - ty))
    else:
        m_int = min(torch.unique(preds).numel(), torch.unique(target).numel())
        m = torch.tensor(m_int, dtype=torch.float32, device=preds.device)
        tau = 2 * (con - dis) / (n**2 * (m - 1) / m)
    return torch.clamp(tau, -1.0, 1.0), con - dis


def _kendall_pvalue(tau: Tensor, n: int, alternative: Optional[str]) -> Tensor:
    """Normal-approximation p-value of tau (the variance is rounded to float32 first, as in the JAX package)."""
    var = (4 * n + 10.0) / (9.0 * n * (n - 1))
    z = tau / torch.sqrt(torch.tensor(var, dtype=torch.float32, device=tau.device))
    if alternative == "two-sided":
        return 2 * (1 - torch.special.ndtr(torch.abs(z)))
    if alternative == "greater":
        return 1 - torch.special.ndtr(z)
    return torch.special.ndtr(z)


def kendall_rank_corrcoef(
    preds: Tensor,
    target: Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Kendall rank correlation (tau-a/b/c), with its p-value under ``t_test``.

    Example:
        >>> import torch
        >>> kendall_rank_corrcoef(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        tensor(1.)
    """
    variant = str(_MetricVariant.from_str(variant))
    if t_test and alternative is not None:
        alternative = str(_TestAlternative.from_str(alternative))
    _check_same_shape(preds, target)
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)

    if preds.ndim == 1:
        tau, _ = _kendall_corrcoef_compute_single(preds, target, variant)
        if t_test:
            return tau, _kendall_pvalue(tau, preds.shape[0], alternative)
        return tau
    taus = torch.stack([_kendall_corrcoef_compute_single(preds[:, i], target[:, i], variant)[0]
                        for i in range(preds.shape[1])])
    if t_test:
        return taus, torch.stack([_kendall_pvalue(tau, preds.shape[0], alternative) for tau in taus])
    return taus
