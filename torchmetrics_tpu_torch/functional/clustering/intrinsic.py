"""Intrinsic clustering metrics on data and labels (port of ``torchmetrics_tpu/functional/clustering/intrinsic.py``).

Cluster sizes and centroid sums are segment sums (``index_add_``), not a
one-hot product. The JAX package builds the ``(K, K, D)`` centroid
differences whole; XLA fuses them into their reduction, eager PyTorch would
not (8.2 GB in float32 at K = 1,000, D = 2,048), so here the rows of the
centroid matrix go in tiles whose temporary stays within ``_TILE_BYTES``.
Each pair sums the same terms over ``D`` as in the JAX package: no
``torch.cdist`` and no Gram identity, whose cancellation would move the
numbers.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import _relabel
from torchmetrics_tpu_torch.utilities.compute import _safe_pow, _safe_sqrt

_TILE_BYTES = 1 << 28  # 256 MiB of float32 centroid differences a tile


def _validate_intrinsic_cluster_data(data: Tensor, labels: Tensor) -> None:
    if data.ndim != 2:
        raise ValueError(f"Expected 2D data, got {data.ndim}D")
    if labels.ndim != 1:
        raise ValueError("Expected 1D labels")
    if data.shape[0] != labels.shape[0]:
        raise ValueError("Expected the same number of samples in `data` and `labels`")


def _cluster_stats(data: Tensor, labels: Tensor) -> Tuple[Tensor, int, Tensor, Tensor]:
    """Dense labels, K, cluster sizes and centroids (JAX ``intrinsic.py:28``)."""
    lab, k = _relabel(labels)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device).index_add_(
        0, lab, torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
    )
    sums = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device).index_add_(0, lab, data)
    return lab, k, counts, sums / torch.clamp(counts[:, None], min=1.0)


def _centroid_pairs(centroids: Tensor, row_fn: Callable[[Tensor], Tensor]) -> Tensor:
    """``row_fn(c[i:j, None, :] - c[None, :, :])`` over row tiles, concatenated to ``(K, K)``."""
    k, d = centroids.shape
    rows = max(1, _TILE_BYTES // max(1, 4 * k * d))
    return torch.cat([row_fn(centroids[i:i + rows, None, :] - centroids[None, :, :]) for i in range(0, k, rows)])


def _data(data: Tensor, labels: Tensor) -> Tuple[Tensor, Tensor]:
    data = torch.as_tensor(data, dtype=torch.float32)
    labels = torch.as_tensor(labels, device=data.device)
    _validate_intrinsic_cluster_data(data, labels)
    return data, labels


def calinski_harabasz_score(data: Tensor, labels: Tensor) -> Tensor:
    """Between/within dispersion ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import calinski_harabasz_score
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.1], [5.0, 5.0], [5.1, 5.1]])
        >>> labels = torch.tensor([0, 0, 1, 1])
        >>> calinski_harabasz_score(data, labels) > 100
        tensor(True)
    """
    data, labels = _data(data, labels)
    n = data.shape[0]
    lab, k, counts, centroids = _cluster_stats(data, labels)
    mean_all = data.mean(dim=0)
    between = torch.sum(counts * torch.sum((centroids - mean_all) ** 2, dim=1))
    within = torch.sum((data - centroids[lab]) ** 2)
    return (between / torch.clamp(within, min=1e-30)) * ((n - k) / max(k - 1, 1))


def davies_bouldin_score(data: Tensor, labels: Tensor) -> Tensor:
    """Average worst-case ratio of within-cluster scatter to between-centroid distance."""
    data, labels = _data(data, labels)
    lab, k, counts, centroids = _cluster_stats(data, labels)
    dists = _safe_sqrt(torch.sum((data - centroids[lab]) ** 2, dim=1))
    scatter = torch.zeros(k, dtype=torch.float32, device=data.device).index_add_(0, lab, dists)
    scatter = scatter / torch.clamp(counts, min=1.0)
    cdist = _centroid_pairs(centroids, lambda diff: _safe_sqrt(torch.sum(diff**2, dim=-1)))
    ratio = (scatter[:, None] + scatter[None, :]) / torch.where(cdist == 0, torch.full_like(cdist, float("inf")), cdist)
    eye = torch.eye(k, dtype=torch.bool, device=data.device)
    ratio = torch.where(eye, torch.full_like(ratio, -float("inf")), ratio)
    return torch.mean(torch.max(ratio, dim=1).values)


def dunn_index(data: Tensor, labels: Tensor, p: float = 2.0) -> Tensor:
    """Dunn index, centroid form: the least p-norm between centroids over the largest from a point to its own."""
    data, labels = _data(data, labels)
    lab, k, _, centroids = _cluster_stats(data, labels)

    def _p_norm(vecs: Tensor) -> Tensor:
        # _safe_pow: x ** (1 / p) has an infinite derivative at 0 (the diagonal, own-centroid terms)
        return _safe_pow(torch.sum(torch.abs(vecs) ** p, dim=-1), 1.0 / p)

    inter = _centroid_pairs(centroids, _p_norm)
    off_diag = ~torch.eye(k, dtype=torch.bool, device=data.device)
    min_inter = torch.min(torch.where(off_diag, inter, torch.full_like(inter, float("inf"))))
    max_intra = torch.max(_p_norm(data - centroids[lab]))
    return min_inter / torch.clamp(max_intra, min=1e-30)
