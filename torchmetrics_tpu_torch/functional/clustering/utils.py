"""Clustering utilities (port of ``torchmetrics_tpu/functional/clustering/utils.py``).

Labels are relabelled to ``0..K-1`` with ``torch.unique`` on the labels' own
device, which gives the sorted codes of ``np.unique``; the one host read is
``K``, which sizes the outputs. The contingency matrix is an integer
``bincount`` of ``t * Kp + p`` cast to float32: the same exact counts as the
JAX package's float32 one-hot einsum. Its ``sparse`` form is a
``torch.sparse_coo_tensor`` where the JAX package returns scipy's
``coo_matrix``; the port imports no scipy.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor


def _relabel(labels: Tensor) -> Tuple[Tensor, int]:
    """Map arbitrary labels to ``0..K-1`` in sorted order, as ``np.unique(..., return_inverse=True)``."""
    uniq, inv = torch.unique(torch.as_tensor(labels).reshape(-1), sorted=True, return_inverse=True)
    return inv, uniq.numel()


def check_cluster_labels(preds: Tensor, target: Tensor) -> None:
    """Both label tensors 1-d and of one shape (JAX ``utils.py:30``)."""
    if preds.ndim != 1 or target.ndim != 1:
        raise ValueError("Expected 1d arrays of cluster labels")
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected `preds` and `target` to have the same shape, got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}"
        )


def calculate_contingency_matrix(
    preds: Tensor, target: Tensor, eps: Optional[float] = None, sparse: bool = False
) -> Tensor:
    """Contingency matrix ``(num_target_classes, num_pred_classes)`` of float32 counts.

    ``sparse`` returns a coalesced ``torch.sparse_coo_tensor`` of float64 ones
    (scipy's ``coo_matrix`` in the JAX package); ``eps`` and ``sparse`` are
    mutually exclusive, as there.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import calculate_contingency_matrix
        >>> calculate_contingency_matrix(torch.tensor([0, 0, 1, 2]), torch.tensor([1, 1, 1, 0]))
        tensor([[0., 0., 1.],
                [2., 1., 0.]])
    """
    if eps is not None and sparse:
        raise ValueError("Cannot specify `eps` and return sparse tensor.")
    p, kp = _relabel(preds)
    t, kt = _relabel(target)
    if sparse:
        values = torch.ones(p.numel(), dtype=torch.float64, device=p.device)
        return torch.sparse_coo_tensor(torch.stack([t, p]), values, (kt, kp), check_invariants=False).coalesce()
    counts = torch.bincount(t * kp + p, minlength=kt * kp).reshape(kt, kp)
    contingency = counts.to(torch.float32)
    if eps is not None:
        contingency = contingency + eps
    return contingency


def calculate_pair_cluster_confusion_matrix(
    preds: Optional[Tensor] = None,
    target: Optional[Tensor] = None,
    contingency: Optional[Tensor] = None,
) -> Tensor:
    """2x2 pair confusion matrix in float32, counts of ordered sample pairs (JAX ``utils.py:65``).

    Off the diagonal, ``[0, 1]`` comes from the contingency's row marginals
    and ``[1, 0]`` from its column marginals, as in sklearn's
    ``pair_confusion_matrix``. The sums are float32 as in the JAX package, so
    pair counts past 2**24 (from about 4,100 samples) round alike in both.
    """
    if contingency is None:
        if preds is None or target is None:
            raise ValueError("Expected both `preds` and `target` when `contingency` is not provided")
        contingency = calculate_contingency_matrix(preds, target)
    n = contingency.sum()
    sum_rows = contingency.sum(dim=1)
    sum_cols = contingency.sum(dim=0)
    sum_squared = torch.sum(contingency**2)
    n11 = sum_squared - n
    n01 = torch.sum(sum_rows**2) - sum_squared
    n10 = torch.sum(sum_cols**2) - sum_squared
    n00 = n**2 - n11 - n10 - n01 - n
    return torch.stack([torch.stack([n00, n01]), torch.stack([n10, n11])])


def calculate_entropy(x: Tensor) -> Tensor:
    """Entropy of a label assignment, natural log (JAX ``utils.py:93``)."""
    lab, k = _relabel(x)
    counts = torch.bincount(lab, minlength=k).to(torch.float32)
    p = counts / counts.sum()
    return -torch.sum(torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)))


def calculate_generalized_mean(x: Tensor, p: Union[str, float]) -> Tensor:
    """Generalized mean: ``'min' | 'max' | 'arithmetic' | 'geometric'`` or a power ``p`` (JAX ``utils.py:101``)."""
    x = torch.as_tensor(x)
    if isinstance(p, str):
        if p == "min":
            return torch.min(x)
        if p == "max":
            return torch.max(x)
        if p == "arithmetic":
            return torch.mean(x)
        if p == "geometric":
            return torch.exp(torch.mean(torch.log(torch.clamp(x, min=1e-30))))
        raise ValueError(f"Invalid generalized mean: {p}")
    return torch.mean(x**p) ** (1.0 / p)
