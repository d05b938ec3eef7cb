"""Plotting helpers (host-side, matplotlib optional).

Port of ``torchmetrics_tpu/utilities/plot.py``: scalar/series plotting with
bound lines and optimal-value annotation, confusion matrix heatmaps, and
(x, y, thresholds) curve plotting. Values are taken to the host here, at the
plot call (``.detach().cpu().numpy()``), never in ``update`` or ``compute``;
matplotlib is imported inside the functions, never at import.
"""

from __future__ import annotations

from math import ceil, floor, sqrt
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from torchmetrics_tpu_torch.utilities.imports import _MATPLOTLIB_AVAILABLE

_error_msg = "matplotlib is required to plot metrics. Install it to use `.plot()`."


def _host(x: Any) -> np.ndarray:
    """``x`` as a host numpy array (a tensor on any device is copied off it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _get_ax(ax: Optional[Any] = None) -> Tuple[Any, Any]:
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.get_figure()
    return fig, ax


def _get_col_row_split(n: int) -> Tuple[int, int]:
    """Split ``n`` sub-figures into a near-square (rows, cols) grid."""
    nsq = sqrt(n)
    if int(nsq) == nsq:
        return int(nsq), int(nsq)
    if floor(nsq) * ceil(nsq) >= n:
        return floor(nsq), ceil(nsq)
    return ceil(nsq), ceil(nsq)


def trim_axs(axs: Any, nb: int) -> Any:
    """Drop all but the first ``nb`` axes from a subplot grid."""
    if not hasattr(axs, "flat"):
        return axs
    axs = axs.flat
    for ax in axs[nb:]:
        ax.remove()
    return axs[:nb]


def plot_single_or_multi_val(
    val: Union[Any, Sequence[Any], Dict[str, Any]],
    ax: Optional[Any] = None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> Tuple[Any, Any]:
    """Plot a scalar, per-class vector, dict of values, or a step sequence,
    with dashed bound lines and an optimal-value marker like the reference."""
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    fig, ax = _get_ax(ax)

    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            arr = _host(v)
            if arr.ndim == 0:
                ax.plot([i], [float(arr)], "o", markersize=10, label=k)
            else:
                ax.plot(arr, marker="o", markersize=10, linestyle="-", label=k)
                ax.set_xlabel("Step")
    elif isinstance(val, (list, tuple)) and not hasattr(val, "shape"):
        if len(val) and isinstance(val[0], dict):
            series = {k: np.stack([_host(v[k]) for v in val]) for k in val[0]}
            for k, v in series.items():
                ax.plot(v, marker="o", markersize=10, linestyle="-", label=k)
        else:
            arr = np.stack([_host(v) for v in val])
            cols = arr.T if arr.ndim != 1 else arr[None, :]
            multi = arr.ndim != 1
            for i, v in enumerate(cols):
                label = (f"{legend_name} {i}" if legend_name else f"{i}") if multi else ""
                ax.plot(v, marker="o", markersize=10, linestyle="-", label=label)
        ax.set_xlabel("Step")
    else:
        arr = _host(val)
        if arr.ndim == 0:
            ax.plot([float(arr)], marker="o", markersize=10)
        else:
            labels = [f"{legend_name or 'class'}_{i}" for i in range(arr.shape[-1])] if arr.ndim == 1 else None
            ax.bar(np.arange(arr.size), arr.ravel(), tick_label=labels)

    handles, labels = ax.get_legend_handles_labels()
    if handles and labels:
        ax.legend(handles, labels, loc="upper center", bbox_to_anchor=(0.5, 1.15), ncol=3, fancybox=True, shadow=True)

    # bound lines + optimal-value annotation (reference plot.py:140-168)
    ylim = ax.get_ylim()
    if lower_bound is not None and upper_bound is not None:
        factor = 0.1 * (upper_bound - lower_bound)
    else:
        factor = 0.1 * (ylim[1] - ylim[0])
    ax.set_ylim(
        bottom=lower_bound - factor if lower_bound is not None else ylim[0] - factor,
        top=upper_bound + factor if upper_bound is not None else ylim[1] + factor,
    )
    ax.grid(True)
    if name:
        ax.set_ylabel(name)

    xlim = ax.get_xlim()
    xfactor = 0.1 * (xlim[1] - xlim[0])
    y_lines: List[float] = []
    if lower_bound is not None:
        y_lines.append(lower_bound)
    if upper_bound is not None:
        y_lines.append(upper_bound)
    if y_lines:
        ax.hlines(y_lines, xlim[0], xlim[1], linestyles="dashed", colors="k")
    if higher_is_better is not None:
        if lower_bound is not None and not higher_is_better:
            ax.set_xlim(xlim[0] - xfactor, xlim[1])
            ax.text(xlim[0], lower_bound, s="Optimal \n value", horizontalalignment="center", verticalalignment="center")
        if upper_bound is not None and higher_is_better:
            ax.set_xlim(xlim[0] - xfactor, xlim[1])
            ax.text(xlim[0], upper_bound, s="Optimal \n value", horizontalalignment="center", verticalalignment="center")
    return fig, ax


def plot_confusion_matrix(
    confmat: Any,
    ax: Optional[Any] = None,
    add_text: bool = True,
    labels: Optional[List[Union[int, str]]] = None,
    cmap: Optional[Any] = None,
) -> Tuple[Any, Any]:
    """Heatmap(s) for a confusion matrix — (C, C) or multilabel (N, 2, 2)
    grids (reference ``plot.py:199``)."""
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    import matplotlib.pyplot as plt

    confmat = _host(confmat)
    if confmat.ndim == 3:  # multilabel: one 2x2 panel per label
        nb, n_classes = confmat.shape[0], 2
        if labels is not None and len(labels) != nb:
            raise ValueError(
                "Expected number of elements in arg `labels` to match number of labels in confmat but "
                f"got {len(labels)} and {nb}"
            )
        rows, cols = _get_col_row_split(nb)
        fig, axs = plt.subplots(nrows=rows, ncols=cols)
        axs = np.atleast_1d(np.asarray(axs, dtype=object))
        axs = trim_axs(axs, nb)
    else:
        nb, n_classes = 1, confmat.shape[0]
        fig, axs = _get_ax(ax)
        if labels is not None and len(labels) != n_classes:
            raise ValueError(
                "Expected number of elements in arg `labels` to match number of labels in confmat but "
                f"got {len(labels)} and {n_classes}"
            )
    if confmat.ndim == 3:
        fig_label = labels or np.arange(nb)
        labels = [0, 1]
    else:
        fig_label = None
        labels = labels if labels is not None else np.arange(n_classes).tolist()

    for i in range(nb):
        axis = axs[i] if confmat.ndim == 3 else axs
        mat = confmat[i] if confmat.ndim == 3 else confmat
        axis.imshow(mat, cmap=cmap)
        if fig_label is not None:
            axis.set_title(f"Label {fig_label[i]}", fontsize=15)
        axis.set_xlabel("Predicted class", fontsize=15)
        axis.set_ylabel("True class", fontsize=15)
        axis.set_xticks(np.arange(len(labels)))
        axis.set_yticks(np.arange(len(labels)))
        axis.set_xticklabels(labels, rotation=45, fontsize=10)
        axis.set_yticklabels(labels, rotation=25, fontsize=10)
        if add_text:
            for ii in range(len(labels)):
                for jj in range(len(labels)):
                    axis.text(jj, ii, str(round(float(mat[ii, jj]), 2)), ha="center", va="center", fontsize=15)
    return fig, axs


def plot_curve(
    curve: Tuple[Any, Any, Any],
    score: Optional[Any] = None,
    ax: Optional[Any] = None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> Tuple[Any, Any]:
    """Plot an (x, y, thresholds) curve family (ROC / PR curves)."""
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(_error_msg)
    fig, ax = _get_ax(ax)
    if isinstance(curve[0], (list, tuple)):  # ragged per-class curves (thresholds=None)
        xs = [_host(c) for c in curve[0]]
        ys = [_host(c) for c in curve[1]]
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            label = f"{legend_name or 'class'}_{i}"
            if score is not None and _host(score).ndim == 1:
                label += f" AUC={float(_host(score)[i]):0.3f}"
            ax.plot(xi, yi, label=label)
    else:
        x, y = _host(curve[0]), _host(curve[1])
        if x.ndim == 1:
            label = f"AUC={float(_host(score)):0.3f}" if score is not None else legend_name
            ax.plot(x, y, linestyle="-", linewidth=2, label=label)
        else:
            for i in range(x.shape[0]):
                label = f"{legend_name or 'class'}_{i}"
                if score is not None and _host(score).ndim == 1:
                    label += f" AUC={float(_host(score)[i]):0.3f}"
                ax.plot(x[i], y[i], label=label)
    handles, labels = ax.get_legend_handles_labels()
    if handles and labels:
        ax.legend()
    ax.grid(True)
    if label_names:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if name:
        ax.set_title(name)
    return fig, ax
