"""Extrinsic (label-vs-label) clustering metrics (port of ``torchmetrics_tpu/functional/clustering/extrinsic.py``).

Float32 results with the JAX package's early returns (NMI 0 when MI is 0,
ARI 1 when there are no false pairs, ...). The expected mutual information
of AMI is the hypergeometric sum the JAX package runs as a triple Python loop
on the host; here it is one sum over the flattened ragged ranges
``nij in [max(1, a_i + b_j - n), min(a_i, b_j)]`` on the contingency's own
device, in float64, in chunks of rows.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_entropy,
    calculate_generalized_mean,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)

_EMI_CHUNK_TERMS = 1 << 22  # terms a chunk of rows: ~7 float64/int64 buffers of this length, ~235 MB


def _scalar(value: float, like: Tensor) -> Tensor:
    """A float32 scalar on ``like``'s device: the JAX package's early-return values."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def mutual_info_score(preds: Tensor, target: Tensor) -> Tensor:
    """Mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import mutual_info_score
        >>> mutual_info_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))
        tensor(0.6931)
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    contingency = calculate_contingency_matrix(preds, target)
    n = contingency.sum()
    pij = contingency / n
    pi = contingency.sum(dim=1, keepdim=True) / n
    pj = contingency.sum(dim=0, keepdim=True) / n
    outer = pi * pj  # the JAX package's (K, 1) @ (1, K) product: one multiplication an entry
    terms = pij * (torch.log(torch.clamp(pij, min=1e-30)) - torch.log(torch.clamp(outer, min=1e-30)))
    return torch.sum(torch.where(pij > 0, terms, torch.zeros_like(terms)))


def normalized_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """NMI = MI / generalized-mean(H(preds), H(target))."""
    mi = mutual_info_score(preds, target)
    if bool(mi == 0):
        return _scalar(0.0, mi)
    norm = calculate_generalized_mean(torch.stack([calculate_entropy(preds), calculate_entropy(target)]), average_method)
    return mi / norm


def _row_chunks(row_terms: List[int], budget: int) -> List[tuple]:
    """Consecutive row ranges whose term counts stay within ``budget`` (a row alone may exceed it)."""
    chunks, start, acc = [], 0, 0
    for i, terms in enumerate(row_terms):
        if acc and acc + terms > budget:
            chunks.append((start, i, acc))
            start, acc = i, 0
        acc += terms
    if acc:
        chunks.append((start, len(row_terms), acc))
    return chunks


def expected_mutual_info_score(contingency: Tensor, n: int) -> float:
    """Hypergeometric E[MI] (sklearn's ``expected_mutual_information``), float64 on the contingency's device.

    The JAX package's loop adds the same terms one by one; here they are
    summed in another order, and log-gamma comes from one float64 table,
    ``lgamma(0..n+1)``. That loop takes log-gamma of the float32 marginals
    where this takes it of exact integers, which moves its EMI by up to ~4e-5
    relative to float64.
    """
    c = torch.as_tensor(contingency).to(torch.float64)
    dev = c.device
    a = c.sum(dim=1).round().to(torch.int64)
    b = c.sum(dim=0).round().to(torch.int64)
    lg = torch.lgamma(torch.arange(n + 2, dtype=torch.float64, device=dev))  # lg[k] = log((k - 1)!)
    start = torch.clamp(a[:, None] + b[None, :] - n, min=1)
    end = torch.minimum(a[:, None], b[None, :])
    count = torch.clamp(end - start + 1, min=0)  # (Ka, Kb) terms of each pair
    # per pair: the parts of each term that do not depend on nij
    log_ab = math.log(n) - torch.log(a.to(torch.float64))[:, None] - torch.log(b.to(torch.float64))[None, :]
    gln_ab = (lg[a + 1][:, None] + lg[b + 1][None, :] + lg[n - a + 1][:, None] + lg[n - b + 1][None, :]) - lg[n + 1]
    emi = torch.zeros((), dtype=torch.float64, device=dev)
    kb = b.numel()
    for lo, hi, terms in _row_chunks(count.sum(dim=1).tolist(), _EMI_CHUNK_TERMS):
        cnt = count[lo:hi].reshape(-1)
        pair = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt, output_size=terms)
        first = torch.cumsum(cnt, 0) - cnt  # each pair's first position in the flattened terms
        nij = start[lo:hi].reshape(-1)[pair] + (torch.arange(terms, device=dev) - first[pair])
        ai = a[lo:hi][pair // kb]
        bj = b[pair % kb]
        nij_f = nij.to(torch.float64)
        gln = gln_ab[lo:hi].reshape(-1)[pair] - lg[nij + 1] - lg[ai - nij + 1] - lg[bj - nij + 1] - lg[n - ai - bj + nij + 1]
        term1 = nij_f / n * (torch.log(nij_f) + log_ab[lo:hi].reshape(-1)[pair])
        emi += torch.sum(term1 * torch.exp(gln))
    return float(emi)


def adjusted_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """AMI = (MI - E[MI]) / (mean(H) - E[MI])."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    contingency = calculate_contingency_matrix(preds, target)
    mi = mutual_info_score(preds, target)
    n = int(contingency.sum())
    emi = expected_mutual_info_score(contingency, n)
    norm = calculate_generalized_mean(torch.stack([calculate_entropy(preds), calculate_entropy(target)]), average_method)
    denom = float(norm) - emi
    if abs(denom) < 1e-15:
        return _scalar(0.0, mi)
    return (mi - emi) / denom


def rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Rand index: the share of sample pairs on which both clusterings agree.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import rand_score
        >>> rand_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))
        tensor(1.)
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    pair = calculate_pair_cluster_confusion_matrix(preds, target)
    total = pair.sum()
    return torch.where(total > 0, (pair[0, 0] + pair[1, 1]) / torch.clamp(total, min=1.0), _scalar(1.0, total))


def adjusted_rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Adjusted Rand index (chance-corrected)."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    pair = calculate_pair_cluster_confusion_matrix(preds, target)
    tn, fp, fn, tp = pair[0, 0], pair[0, 1], pair[1, 0], pair[1, 1]
    if bool(fn == 0) and bool(fp == 0):
        return _scalar(1.0, pair)
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def homogeneity_score(preds: Tensor, target: Tensor) -> Tensor:
    """Homogeneity: each cluster holds members of one class only."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    h_target = calculate_entropy(target)
    if bool(h_target == 0):
        return _scalar(1.0, h_target)
    contingency = calculate_contingency_matrix(preds, target)  # H(target | preds)
    n = contingency.sum()
    p_cluster = contingency.sum(dim=0) / n
    p_joint = contingency / n
    terms = p_joint * (
        torch.log(torch.clamp(p_joint, min=1e-30)) - torch.log(torch.clamp(p_cluster[None, :], min=1e-30))
    )
    cond = -torch.sum(torch.where(p_joint > 0, terms, torch.zeros_like(terms)))
    return 1.0 - cond / h_target


def completeness_score(preds: Tensor, target: Tensor) -> Tensor:
    """Completeness: all members of a class fall in one cluster."""
    return homogeneity_score(target, preds)


def v_measure_score(preds: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """V-measure: the weighted harmonic mean of homogeneity and completeness."""
    h = homogeneity_score(preds, target)
    c = completeness_score(preds, target)
    if bool(h + c == 0):
        return _scalar(0.0, h)
    return (1 + beta) * h * c / (beta * h + c)


def fowlkes_mallows_index(preds: Tensor, target: Tensor) -> Tensor:
    """FMI = TP / sqrt((TP + FP)(TP + FN)) over sample pairs."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    check_cluster_labels(preds, target)
    pair = calculate_pair_cluster_confusion_matrix(preds, target)
    tp, fp, fn = pair[1, 1], pair[0, 1], pair[1, 0]
    denom = torch.sqrt((tp + fp) * (tp + fn))
    return torch.where(denom > 0, tp / torch.clamp(denom, min=1.0), _scalar(0.0, denom))
