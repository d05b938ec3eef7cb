"""Precision-recall curves, ROC and AUROC of the port against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages' functionals and classes
in exact mode (``thresholds=None``) and binned mode. Scores are drawn from a
few values, so ties are everywhere: both packages sort stably and must give
the same thresholds. Curves and AUROC are held at ``atol=1e-6`` (float32
cumulative sums, divisions and a trapezoid sum in another order); binned
counts and thresholds are compared exactly.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu.utilities.compute as jax_compute
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.functional.classification as TF
import torchmetrics_tpu_torch.utilities.compute as torch_compute
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

N, C, L = 60, 3, 3
ATOL = 1e-6


def assert_tree(got, want):
    """Leaf by leaf: same nesting, shapes and dtype kinds; integers exact, floats within ``ATOL``."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree(g, w)
        return
    assert isinstance(got, torch.Tensor)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind in "iub"
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def run_both(name, arrays, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn on a class without positives or negatives
        want = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **_jax_kwargs(kwargs))
        got = getattr(TF, name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    assert_tree(got, want)


def _jax_kwargs(kwargs):
    return {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}


def tied_scores(rng, shape, logits=False):
    """Scores from 6 values: 0, 0.2, ..., 1 (or their logits), so most rows tie with others."""
    scores = (rng.integers(0, 6, shape) / 5).astype(np.float32)
    return (scores * 8 - 4).astype(np.float32) if logits else scores


def binary_data(seed, logits=False, ignore_index=None):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 2, N)
    if ignore_index is not None:
        target[rng.random(N) < 0.2] = ignore_index
    return tied_scores(rng, N, logits), target


def multiclass_data(seed, ignore_index=None):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, C, N)
    if ignore_index is not None:
        target[rng.random(N) < 0.2] = ignore_index
    probs = tied_scores(rng, (N, C)) + 0.01
    return (probs / probs.sum(1, keepdims=True)).astype(np.float32), target


def multilabel_data(seed, logits=False, ignore_index=None):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 2, (N, L))
    if ignore_index is not None:
        target[rng.random((N, L)) < 0.2] = ignore_index
    return tied_scores(rng, (N, L), logits), target


THRESHOLDS = {"exact": None, "int": 11, "list": [0.0, 0.1, 0.35, 0.5, 0.9, 1.0]}


# each data-dependent shape (exact mode, an ignore_index filter) costs the JAX side a compile:
# the grids below pair the options instead of crossing them all
@pytest.mark.parametrize(("logits", "ignore_index"), [(False, None), (True, -1)])
@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("name", ["binary_precision_recall_curve", "binary_roc", "binary_auroc"])
def test_binary(name, thresholds, logits, ignore_index):
    run_both(name, binary_data(1, logits, ignore_index), thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


@pytest.mark.parametrize("thresholds", [None, 7])
@pytest.mark.parametrize("max_fpr", [0.3, 0.75, 1.0])
def test_binary_auroc_max_fpr(max_fpr, thresholds):
    run_both("binary_auroc", binary_data(2), max_fpr=max_fpr, thresholds=thresholds)


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("int", None), ("list", -1)])
@pytest.mark.parametrize("average", [None, "micro", "macro"])
@pytest.mark.parametrize("name", ["multiclass_precision_recall_curve", "multiclass_roc"])
def test_multiclass_curves(name, average, thresholds, ignore_index):
    run_both(name, multiclass_data(3, ignore_index), num_classes=C, average=average,
             thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", None), ("int", -1), ("list", None)])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multiclass_auroc(average, thresholds, ignore_index):
    run_both("multiclass_auroc", multiclass_data(4, ignore_index), num_classes=C, average=average,
             thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("int", None), ("list", -1)])
@pytest.mark.parametrize("name", ["multilabel_precision_recall_curve", "multilabel_roc"])
def test_multilabel_curves(name, thresholds, ignore_index):
    run_both(name, multilabel_data(5, ignore_index=ignore_index), num_labels=L,
             thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("int", None), ("list", -1)])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multilabel_auroc(average, thresholds, ignore_index):
    run_both("multilabel_auroc", multilabel_data(6, logits=True, ignore_index=ignore_index), num_labels=L,
             average=average, thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name", ["precision_recall_curve", "roc", "auroc"])
def test_task_dispatch(name, task):
    arrays = {"binary": binary_data(7), "multiclass": multiclass_data(7), "multilabel": multilabel_data(7)}[task]
    run_both(name, arrays, task=task, thresholds=5, num_classes=C, num_labels=L)


def test_thresholds_tensor_argument():
    grid = torch.tensor([0.05, 0.4, 0.6, 0.95])
    run_both("multiclass_precision_recall_curve", multiclass_data(8), num_classes=C, thresholds=grid)


@pytest.mark.parametrize("n", [2, 5, 7, 100, 1001])
def test_integer_thresholds_match_jax_linspace_bits(n):
    np.testing.assert_array_equal(_adjust_threshold_arg(n).numpy(), np.asarray(jnp.linspace(0, 1, n)))


def test_exact_auroc_against_rank_sum():
    """Exact binary AUROC with ties is the Mann-Whitney statistic (float64 ranks, ties averaged)."""
    preds, target = binary_data(9)
    ranks = rankdata(preds.astype(np.float64))
    pos = target == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    want = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    got = TF.binary_auroc(torch.from_numpy(preds), torch.from_numpy(target))
    assert abs(float(got) - want) < 1e-6


def test_interp_and_auc():
    rng = np.random.default_rng(10)
    x = rng.random(25).astype(np.float32) * 1.4 - 0.2  # points past both ends: linear extrapolation
    xp = rng.random(9).astype(np.float32)  # not sorted: the segment is picked by count
    fp = rng.random(9).astype(np.float32)
    got = torch_compute.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    assert_tree(got, jax_compute.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    assert_tree(torch_compute.interp(torch.tensor(0.3), torch.from_numpy(xp), torch.from_numpy(fp)),
                jax_compute.interp(jnp.float32(0.3), jnp.asarray(xp), jnp.asarray(fp)))
    for reorder in (False, True):
        assert_tree(torch_compute.auc(torch.from_numpy(xp), torch.from_numpy(fp), reorder=reorder),
                    jax_compute.auc(jnp.asarray(xp), jnp.asarray(fp), reorder=reorder))


CLASSES = {
    "BinaryAUROC_exact": ("BinaryAUROC", {}, lambda s: binary_data(s)),
    "BinaryAUROC_binned_max_fpr": ("BinaryAUROC", {"thresholds": 9, "max_fpr": 0.5}, lambda s: binary_data(s, True)),
    "BinaryROC_exact_ignore": ("BinaryROC", {"ignore_index": -1}, lambda s: binary_data(s, ignore_index=-1)),
    "BinaryPrecisionRecallCurve_binned": ("BinaryPrecisionRecallCurve", {"thresholds": 6}, lambda s: binary_data(s)),
    "MulticlassAUROC_exact": ("MulticlassAUROC", {"num_classes": C}, lambda s: multiclass_data(s)),
    "MulticlassAUROC_binned_weighted": (
        "MulticlassAUROC", {"num_classes": C, "thresholds": 11, "average": "weighted"}, lambda s: multiclass_data(s)
    ),
    "MulticlassROC_binned_macro": ("MulticlassROC", {"num_classes": C, "thresholds": 5, "average": "macro"},
                                   lambda s: multiclass_data(s)),
    "MulticlassPrecisionRecallCurve_exact_ignore": (
        "MulticlassPrecisionRecallCurve", {"num_classes": C, "ignore_index": -1},
        lambda s: multiclass_data(s, ignore_index=-1),
    ),
    "MultilabelAUROC_exact_ignore": ("MultilabelAUROC", {"num_labels": L, "ignore_index": -1},
                                     lambda s: multilabel_data(s, ignore_index=-1)),
    "MultilabelAUROC_binned_micro": ("MultilabelAUROC", {"num_labels": L, "thresholds": 7, "average": "micro"},
                                     lambda s: multilabel_data(s, logits=True)),
    "MultilabelROC_binned": ("MultilabelROC", {"num_labels": L, "thresholds": [0.1, 0.5, 0.8]},
                             lambda s: multilabel_data(s)),
    "MultilabelPrecisionRecallCurve_exact": ("MultilabelPrecisionRecallCurve", {"num_labels": L},
                                             lambda s: multilabel_data(s)),
}


def stream_pair(jm, tm, make, batches=3, seed=20):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in range(batches):
            arrays = make(seed + b)
            j_args, t_args = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
            if b % 2 == 0:
                assert_tree(tm(*t_args), jm(*j_args))
            else:
                jm.update(*j_args)
                tm.update(*t_args)
        assert_tree(tm.compute(), jm.compute())


@pytest.mark.parametrize("config", sorted(CLASSES))
def test_class_stream(config):
    """Three batches, alternating ``forward`` and ``update``: each batch value and the final ``compute``."""
    cls_name, kwargs, make = CLASSES[config]
    stream_pair(getattr(JC, cls_name)(auto_compile=False, **kwargs), getattr(TC, cls_name)(device="cpu", **kwargs), make)


@pytest.mark.parametrize("config", ["BinaryAUROC_exact", "MulticlassAUROC_exact", "MultilabelAUROC_exact_ignore"])
def test_class_stream_in_ring_buffers(config):
    """Exact mode with ``cat_state_capacity``: the cat states are ring buffers, the values the same."""
    cls_name, kwargs, make = CLASSES[config]
    jm = getattr(JC, cls_name)(auto_compile=False, cat_state_capacity=4 * N, **kwargs)
    tm = getattr(TC, cls_name)(device="cpu", cat_state_capacity=4 * N, **kwargs)
    stream_pair(jm, tm, make)
    assert type(tm.preds).__name__ == "RingBuffer" and len(tm.preds) == len(jm.preds)


def test_binned_state_is_int32_and_moves_with_the_metric():
    metric = TC.MulticlassAUROC(num_classes=C, thresholds=11, device="cpu")
    metric.update(*[torch.from_numpy(a) for a in multiclass_data(11)])
    assert metric.confmat.dtype == torch.int32 and metric.confmat.shape == (11, C, 2, 2)
    assert int(metric.confmat[0].sum()) == N * C
    moved = metric.to("cpu", torch.float64)  # Module._apply: the thresholds move with the states, uncast
    assert moved is metric and moved.thresholds.dtype == torch.float32 and moved.thresholds.device.type == "cpu"
    task = TC.AUROC(task="multiclass", num_classes=C, device="cpu")
    assert isinstance(task, TC.MulticlassAUROC)
    assert isinstance(TC.ROC(task="binary", device="cpu"), TC.BinaryROC)
    assert isinstance(TC.PrecisionRecallCurve(task="multilabel", num_labels=L, device="cpu"),
                      TC.MultilabelPrecisionRecallCurve)
