"""MCC, Cohen's kappa and the Jaccard index of the port against the JAX package, on the CPU.

The three families reduce a confusion matrix, so they share its states and,
from 256 classes on, its kernel (here its plain version, since the tensors
lie on the CPU). The same seeded numpy inputs go through ``torchmetrics_tpu``
(JAX on the CPU; classes built with ``auto_compile=False``, the eager form the
port carries) and ``torchmetrics_tpu_torch`` (CPU tensors, ``device="cpu"``).
Tolerances: counts exact; the float32 reductions ``atol=1e-6, rtol=1e-6``
(a few roundings of sums over at most a few hundred cells; the port and XLA
may add in different orders).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.functional.classification as TF
from torchmetrics_tpu_torch.utilities import state_from_jax

from tests.test_torch_classification import C, C_LARGE, L, binary_inputs, multiclass_inputs, multilabel_inputs

ATOL = RTOL = 1e-6


def assert_tree(got, want, atol=ATOL, rtol=RTOL):
    """Leaf by leaf: same nesting, keys and shapes; integers exact, floats within the tolerance (NaN where NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (sorted(got), sorted(want))
        for key in want:
            assert_tree(got[key], want[key], atol, rtol)
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree(g, w, atol, rtol)
        return
    assert isinstance(got, torch.Tensor)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind in "iub", (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype.kind == "f", (got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, equal_nan=True)


def run_both(name, arrays, atol=ATOL, rtol=RTOL, **kwargs):
    """One functional of both packages on the same arrays."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
        got = getattr(TF, name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    assert_tree(got, want, atol, rtol)


def stream_pair(cls_name, kwargs, make, batches=4, seed=40, atol=ATOL, rtol=RTOL, forward=True):
    """One class of both packages over ``batches`` batches, alternating ``forward`` and ``update`` (or updates only)."""
    jm = getattr(JC, cls_name)(auto_compile=False, **kwargs)
    tm = getattr(TC, cls_name)(device="cpu", **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in range(batches):
            arrays = make(seed + b)
            j_args, t_args = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
            if forward and b % 2 == 0:
                assert_tree(tm(*t_args), jm(*j_args), atol, rtol)
            else:
                jm.update(*j_args)
                tm.update(*t_args)
        assert_tree(tm.compute(), jm.compute(), atol, rtol)
    return jm, tm


# ------------------------------------------------------------------- functionals


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("name", ["binary_matthews_corrcoef", "binary_jaccard_index", "binary_cohen_kappa"])
def test_binary(name, logits, ignore_index):
    run_both(name, binary_inputs(101, logits=logits, ignore_index=ignore_index), ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("c", [C, C_LARGE])
def test_multiclass_matthews_corrcoef(c, ignore_index):
    run_both("multiclass_matthews_corrcoef", multiclass_inputs(102, c=c, ignore_index=ignore_index), num_classes=c,
             ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_matthews_corrcoef(ignore_index):
    arrays = multilabel_inputs(103, logits=True, ignore_index=ignore_index)
    run_both("multilabel_matthews_corrcoef", arrays, num_labels=L, ignore_index=ignore_index)


@pytest.mark.parametrize("weights", [None, "none", "linear", "quadratic"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("c", [C, C_LARGE])
def test_multiclass_cohen_kappa(c, ignore_index, weights):
    run_both("multiclass_cohen_kappa", multiclass_inputs(104, c=c, ignore_index=ignore_index), num_classes=c,
             weights=weights, ignore_index=ignore_index)


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
def test_binary_cohen_kappa_weights(weights):
    run_both("binary_cohen_kappa", binary_inputs(105), weights=weights)


@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("c", [C, C_LARGE])
def test_multiclass_jaccard_index(c, average, ignore_index):
    run_both("multiclass_jaccard_index", multiclass_inputs(106, c=c, ignore_index=ignore_index), num_classes=c,
             average=average, ignore_index=ignore_index)


@pytest.mark.parametrize("c", [C, C_LARGE])
def test_multiclass_jaccard_index_from_label_maps(c):
    """(N, E) label maps with void pixels, as a segmentation evaluator passes them; macro is mean IoU."""
    arrays = multiclass_inputs(107, c=c, samplewise=True, labels=True, ignore_index=-1)
    for average in ("macro", "none"):
        run_both("multiclass_jaccard_index", arrays, num_classes=c, average=average, ignore_index=-1)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multilabel_jaccard_index(average, ignore_index):
    arrays = multilabel_inputs(108, logits=True, ignore_index=ignore_index)
    run_both("multilabel_jaccard_index", arrays, num_labels=L, average=average, ignore_index=ignore_index)


@pytest.mark.parametrize(
    ("task", "extra"),
    [("binary", {}), ("multiclass", {"num_classes": C}), ("multilabel", {"num_labels": L})],
)
@pytest.mark.parametrize("name", ["matthews_corrcoef", "jaccard_index", "cohen_kappa"])
def test_task_dispatch(name, task, extra):
    if name == "cohen_kappa" and task == "multilabel":
        with pytest.raises(ValueError):
            TF.cohen_kappa(torch.zeros(4, L), torch.zeros(4, L, dtype=torch.int64), task=task)
        return
    arrays = {"binary": binary_inputs(109), "multiclass": multiclass_inputs(109), "multilabel": multilabel_inputs(109)}
    run_both(name, arrays[task], task=task, **extra)


# ------------------------------------------------------------------- edge cases


@pytest.mark.parametrize(
    "pair",
    [
        ([0, 0, 0, 0], [0, 0, 0, 0]),  # one class only: tp = fp = fn = 0
        ([1, 1, 1, 1], [1, 1, 1, 1]),  # tn = fp = fn = 0
        ([1, 1, 1, 1], [0, 0, 0, 0]),  # every prediction wrong, a single column
        ([0, 1, 0, 1], [0, 0, 0, 0]),  # target of one class
        ([0, 0, 1, 1], [0, 1, 0, 1]),  # balanced: MCC 0
    ],
)
def test_binary_degenerate_matrices(pair):
    """MCC's branchless degenerate cases, kappa's 0/0 and Jaccard's unguarded division agree, NaN included."""
    preds, target = (np.asarray(p, dtype=np.int64) for p in pair)
    for name in ("binary_matthews_corrcoef", "binary_cohen_kappa", "binary_jaccard_index"):
        run_both(name, (preds, target))


def test_binary_jaccard_of_an_empty_matrix_is_nan():
    """``average="binary"`` divides without ``_safe_divide``: every row ignored gives NaN, not 0."""
    got = TF.binary_jaccard_index(torch.tensor([0.3, 0.8]), torch.tensor([-1, -1]), ignore_index=-1)
    assert torch.isnan(got)
    run_both("binary_jaccard_index", (np.array([0.3, 0.8], np.float32), np.array([-1, -1])), ignore_index=-1)


def test_multiclass_degenerate_matrices():
    """A class never seen, a class only predicted and a perfect column: MCC, kappa and macro IoU all agree."""
    preds = np.array([0, 0, 2, 2, 3, 3, 3, 0])
    target = np.array([0, 0, 0, 2, 3, 3, 3, 0])
    for name, kwargs in (("multiclass_matthews_corrcoef", {}), ("multiclass_cohen_kappa", {"weights": "quadratic"}),
                         ("multiclass_jaccard_index", {"average": "macro"}),
                         ("multiclass_jaccard_index", {"average": "weighted"})):
        run_both(name, (preds, target), num_classes=C, **kwargs)
    run_both("multiclass_matthews_corrcoef", (np.zeros(6, np.int64), np.zeros(6, np.int64)), num_classes=C)


# ------------------------------------------------------------------- classes

CLASSES = {
    "BinaryMatthewsCorrCoef": ({"ignore_index": -1}, lambda s: binary_inputs(s, logits=True, ignore_index=-1)),
    "MulticlassMatthewsCorrCoef": ({"num_classes": C}, lambda s: multiclass_inputs(s)),
    "MulticlassMatthewsCorrCoef_large": ({"num_classes": C_LARGE, "ignore_index": -1},
                                         lambda s: multiclass_inputs(s, c=C_LARGE, ignore_index=-1)),
    "MultilabelMatthewsCorrCoef": ({"num_labels": L}, lambda s: multilabel_inputs(s)),
    "BinaryCohenKappa": ({"weights": "linear"}, lambda s: binary_inputs(s)),
    "MulticlassCohenKappa": ({"num_classes": C, "weights": "quadratic"}, lambda s: multiclass_inputs(s)),
    "MulticlassCohenKappa_large": ({"num_classes": C_LARGE}, lambda s: multiclass_inputs(s, c=C_LARGE)),
    "BinaryJaccardIndex": ({}, lambda s: binary_inputs(s)),
    "MulticlassJaccardIndex": ({"num_classes": C, "average": "weighted", "ignore_index": 1},
                               lambda s: multiclass_inputs(s, ignore_index=1)),
    "MulticlassJaccardIndex_large": ({"num_classes": C_LARGE, "ignore_index": -1},
                                     lambda s: multiclass_inputs(s, c=C_LARGE, samplewise=True, labels=True,
                                                                 ignore_index=-1)),
    "MultilabelJaccardIndex": ({"num_labels": L, "average": "none"}, lambda s: multilabel_inputs(s, logits=True)),
}


@pytest.mark.parametrize("config", sorted(CLASSES))
def test_class_stream(config):
    """Four batches, alternating ``forward`` and ``update``: each batch value and the final ``compute``."""
    kwargs, make = CLASSES[config]
    stream_pair(config.split("_")[0], kwargs, make)


@pytest.mark.parametrize(
    ("wrapper", "kwargs", "expected"),
    [
        ("MatthewsCorrCoef", {"task": "multilabel", "num_labels": L}, "MultilabelMatthewsCorrCoef"),
        ("CohenKappa", {"task": "multiclass", "num_classes": C, "weights": "linear"}, "MulticlassCohenKappa"),
        ("JaccardIndex", {"task": "binary"}, "BinaryJaccardIndex"),
        ("JaccardIndex", {"task": "multiclass", "num_classes": C, "average": "none"}, "MulticlassJaccardIndex"),
    ],
)
def test_task_wrappers(wrapper, kwargs, expected):
    metric = getattr(TC, wrapper)(device="cpu", **kwargs)
    assert type(metric).__name__ == expected and metric.device == torch.device("cpu")


def test_kappa_validates_its_own_arguments():
    """The classes hand ``validate_args=False`` to the confusion matrix and check ``weights`` themselves."""
    with pytest.raises(ValueError, match="weight"):
        TC.MulticlassCohenKappa(num_classes=C, weights="cubic", device="cpu")
    with pytest.raises(ValueError, match="weight"):
        TC.BinaryCohenKappa(weights="cubic", device="cpu")
    TC.MulticlassCohenKappa(num_classes=C, weights="cubic", validate_args=False, device="cpu")


def test_the_family_keeps_the_confusion_matrix_state():
    """Same state names, shapes and dtype as ``MulticlassConfusionMatrix``: one compute group in a collection."""
    members = [TC.MulticlassConfusionMatrix(num_classes=C_LARGE, device="cpu"),
               TC.MulticlassJaccardIndex(num_classes=C_LARGE, device="cpu"),
               TC.MulticlassMatthewsCorrCoef(num_classes=C_LARGE, device="cpu"),
               TC.MulticlassCohenKappa(num_classes=C_LARGE, device="cpu")]
    for m in members:
        assert list(m._defaults) == ["confmat"]
        assert m.confmat.shape == (C_LARGE, C_LARGE) and m.confmat.dtype == torch.int32


@pytest.mark.parametrize(
    ("cls_name", "kwargs", "make"),
    [
        ("MulticlassMatthewsCorrCoef", {"num_classes": C_LARGE}, lambda s: multiclass_inputs(s, c=C_LARGE)),
        ("MulticlassJaccardIndex", {"num_classes": C, "ignore_index": -1},
         lambda s: multiclass_inputs(s, ignore_index=-1)),
    ],
)
def test_state_from_jax(cls_name, kwargs, make):
    """A JAX metric's state, carried over with ``state_from_jax``, computes the same value in the port."""
    jm = getattr(JC, cls_name)(auto_compile=False, **kwargs)
    for s in range(3):
        jm.update(*[jnp.asarray(a) for a in make(110 + s)])
    tm = getattr(TC, cls_name)(device="cpu", **kwargs)
    tm.load_state_dict(state_from_jax(jm.state_dict(all_states=True), device="cpu"))
    assert_tree(tm.compute(), jm.compute())
    both = make(113)
    jm.update(*[jnp.asarray(a) for a in both])
    tm.update(*[torch.from_numpy(a) for a in both])
    assert_tree(tm.compute(), jm.compute())
