"""Functional nominal-association metrics (port of ``torchmetrics_tpu/functional/nominal/__init__.py``).

Categories go through float32 to int32 as in the JAX package, so a category
id above 2**24 rounds in both. Contingency matrices are integer counts cast
to float32 (``calculate_contingency_matrix``); the ``(C, C)`` co-occurrence
state of the classes drops any pair with a value outside ``[0, C)``, as the
JAX package's ``jax.nn.one_hot`` rows of zeros do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix
from torchmetrics_tpu_torch.utilities.data import _one_hot


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ("replace", "drop"):
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (int, float)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan(
    preds: Tensor, target: Tensor, nan_strategy: str, nan_replace_value: Optional[float]
) -> Tuple[Tensor, Tensor]:
    """Replace or drop NaN pairs, then float32 to int32 category ids (JAX ``nominal/__init__.py:28``)."""
    preds = torch.as_tensor(preds).to(torch.float32).reshape(-1)
    target = torch.as_tensor(target, device=preds.device).to(torch.float32).reshape(-1)
    if nan_strategy == "replace":
        preds = torch.where(torch.isnan(preds), torch.full_like(preds, nan_replace_value), preds)
        target = torch.where(torch.isnan(target), torch.full_like(target, nan_replace_value), target)
    else:
        keep = ~(torch.isnan(preds) | torch.isnan(target))
        preds, target = preds[keep], target[keep]
    return preds.to(torch.int32), target.to(torch.int32)


def _chi2(confmat: Tensor) -> Tensor:
    n = confmat.sum()
    expected = torch.outer(confmat.sum(dim=1), confmat.sum(dim=0)) / n
    terms = (confmat - expected) ** 2 / torch.clamp(expected, min=1e-30)
    return torch.sum(torch.where(expected > 0, terms, torch.zeros_like(terms)))


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tensor:
    """Drop all-zero rows and columns (unseen categories of a ``num_classes`` state)."""
    confmat = confmat[confmat.sum(dim=1) != 0]
    return confmat[:, confmat.sum(dim=0) != 0]


def _confmat_from_pairs(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """``(C, C)`` float32 co-occurrence counts, rows preds and columns target.

    A pair with either value outside ``[0, C)`` counts nowhere (the JAX
    package's one-hot gives it a row of zeros); such pairs go to one extra
    bin of the integer ``bincount``, which is then dropped.
    """
    p, t = preds.to(torch.int64), target.to(torch.int64)
    valid = (p >= 0) & (p < num_classes) & (t >= 0) & (t < num_classes)
    cells = num_classes * num_classes
    idx = torch.where(valid, p * num_classes + t, torch.full_like(p, cells))
    return torch.bincount(idx, minlength=cells + 1)[:cells].reshape(num_classes, num_classes).to(torch.float32)


def _bias_corrected(confmat: Tensor, bias_correction: bool) -> Tuple[Tensor, float, float]:
    """``phi2`` and the row and column counts, bias-corrected with ``n - 1`` read on the host (JAX ``:75``)."""
    n = confmat.sum()
    r, k = confmat.shape
    phi2 = _chi2(confmat) / n
    if bias_correction:
        phi2 = torch.clamp(phi2 - (r - 1) * (k - 1) / (n - 1), min=0.0)
        n_minus_1 = float(n - 1)
        r = r - (r - 1) ** 2 / n_minus_1
        k = k - (k - 1) ** 2 / n_minus_1
    return phi2, r, k


def _cramers_v_from_confmat(confmat: Tensor, bias_correction: bool) -> Tensor:
    phi2, r, k = _bias_corrected(confmat, bias_correction)
    denom = torch.tensor(min(r - 1, k - 1), dtype=torch.float32, device=confmat.device)
    return torch.sqrt(phi2 / torch.clamp(denom, min=1e-30))


def _tschuprows_t_from_confmat(confmat: Tensor, bias_correction: bool) -> Tensor:
    phi2, r, k = _bias_corrected(confmat, bias_correction)
    denom = torch.tensor((r - 1) * (k - 1), dtype=torch.float32, device=confmat.device)
    return torch.sqrt(phi2 / torch.sqrt(torch.clamp(denom, min=1e-30)))


def _pearsons_contingency_from_confmat(confmat: Tensor) -> Tensor:
    n = confmat.sum()
    chi2 = _chi2(confmat)
    return torch.sqrt(chi2 / (chi2 + n))


def _theils_u_from_confmat(confmat: Tensor) -> Tensor:
    """Theil's U from a (preds, target)-oriented contingency matrix."""
    n = confmat.sum()
    p_joint = confmat / n
    p_x = p_joint.sum(dim=1)  # the preds marginal
    p_y = p_joint.sum(dim=0)
    zero = torch.zeros((), dtype=p_joint.dtype, device=p_joint.device)
    h_x = -torch.sum(torch.where(p_x > 0, p_x * torch.log(torch.clamp(p_x, min=1e-30)), zero))
    joint_terms = p_joint * (torch.log(torch.clamp(p_joint, min=1e-30)) - torch.log(torch.clamp(p_y[None, :], min=1e-30)))
    h_xy = -torch.sum(torch.where(p_joint > 0, joint_terms, zero))
    return torch.where(h_x == 0, zero, (h_x - h_xy) / torch.clamp(h_x, min=1e-30))


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramér's V association between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import cramers_v
        >>> cramers_v(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]), bias_correction=False)
        tensor(1.)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target = _handle_nan(preds, target, nan_strategy, nan_replace_value)
    return _cramers_v_from_confmat(calculate_contingency_matrix(preds, target), bias_correction)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T association."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target = _handle_nan(preds, target, nan_strategy, nan_replace_value)
    return _tschuprows_t_from_confmat(calculate_contingency_matrix(preds, target), bias_correction)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient sqrt(chi2 / (chi2 + n))."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target = _handle_nan(preds, target, nan_strategy, nan_replace_value)
    return _pearsons_contingency_from_confmat(calculate_contingency_matrix(preds, target))


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U (uncertainty coefficient): U(preds | target), asymmetric."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds, target = _handle_nan(preds, target, nan_strategy, nan_replace_value)
    # rows: preds categories (x), columns: target categories (y)
    return _theils_u_from_confmat(calculate_contingency_matrix(target, preds))


def _fleiss_kappa_update(ratings: Tensor, mode: str) -> Tensor:
    """Ratings as a per-subject category-count matrix (JAX ``nominal/__init__.py:178``).

    ``mode='probs'`` takes ``(n_subjects, n_categories, n_raters)`` floating
    scores and counts each rater's argmax category.
    """
    if mode == "probs":
        if ratings.ndim != 3 or not torch.is_floating_point(ratings):
            raise ValueError(
                "If argument `mode` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        choice = torch.argmax(ratings, dim=1)  # (n_subjects, n_raters)
        return _one_hot(choice, ratings.shape[1], dtype=torch.int32).sum(dim=1, dtype=torch.int32)
    if ratings.ndim != 2 or torch.is_floating_point(ratings):
        raise ValueError(
            "If argument `mode` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    """Kappa from a count matrix: the rater count is the largest row sum (JAX ``nominal/__init__.py:201``)."""
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(dim=1).max()
    p_cat = counts.sum(dim=0) / (total * num_raters)
    p_subject = (torch.sum(counts**2, dim=1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = torch.mean(p_subject)
    pe_bar = torch.sum(p_cat**2)
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: str = "counts") -> Tensor:
    """Fleiss' kappa for inter-rater agreement.

    ``mode='counts'``: an integer ``(n_subjects, n_categories)`` count matrix;
    ``mode='probs'``: ``(n_subjects, n_categories, n_raters)`` floating scores,
    each rater's argmax taken as their category.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import fleiss_kappa
        >>> ratings = torch.tensor([[5, 0], [3, 2], [0, 5], [5, 0]])
        >>> round(float(fleiss_kappa(ratings)), 3)
        0.67
    """
    if mode not in ("counts", "probs"):
        raise ValueError("Argument `mode` must be one of 'counts' or 'probs'")
    return _fleiss_kappa_compute(_fleiss_kappa_update(torch.as_tensor(ratings), mode))


from torchmetrics_tpu_torch.functional.nominal._matrix import (  # noqa: E402
    cramers_v_matrix,
    pearsons_contingency_coefficient_matrix,
    theils_u_matrix,
    tschuprows_t_matrix,
)

__all__ = [
    "cramers_v",
    "cramers_v_matrix",
    "pearsons_contingency_coefficient_matrix",
    "theils_u_matrix",
    "tschuprows_t_matrix",
    "fleiss_kappa",
    "pearsons_contingency_coefficient",
    "theils_u",
    "tschuprows_t",
]
