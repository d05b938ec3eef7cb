"""Specificity, Hamming distance, exact match and Dice of the port against the JAX package, on the CPU.

The same seeded numpy inputs go through ``torchmetrics_tpu`` (JAX on the CPU;
classes built with ``auto_compile=False``) and ``torchmetrics_tpu_torch`` (CPU
tensors, ``device="cpu"``). Tolerances: counts exact; ratios ``atol=1e-6,
rtol=1e-6`` (one float32 division and a short sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.functional.classification as TF

from tests.test_torch_classification import C, C_LARGE, E, L, N, binary_inputs, multiclass_inputs, multilabel_inputs
from tests.test_torch_confmat_family import assert_tree, run_both, stream_pair

AVERAGES = ["micro", "macro", "weighted", "none"]
FNS = ["specificity", "hamming_distance"]


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("fn", FNS)
def test_binary(fn, multidim_average, ignore_index):
    arrays = binary_inputs(201, samplewise=multidim_average == "samplewise", logits=True, ignore_index=ignore_index)
    run_both(f"binary_{fn}", arrays, multidim_average=multidim_average, ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multiclass(fn, average, top_k, ignore_index):
    run_both(f"multiclass_{fn}", multiclass_inputs(202, ignore_index=ignore_index), num_classes=C, average=average,
             top_k=top_k, ignore_index=ignore_index)


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multiclass_samplewise(fn, average):
    arrays = multiclass_inputs(203, samplewise=True, labels=True, ignore_index=-1)
    run_both(f"multiclass_{fn}", arrays, num_classes=C, average=average, multidim_average="samplewise",
             ignore_index=-1)


@pytest.mark.parametrize("fn", FNS)
def test_multiclass_many_classes(fn):
    run_both(f"multiclass_{fn}", multiclass_inputs(204, c=C_LARGE, ignore_index=-1), num_classes=C_LARGE,
             average="macro", ignore_index=-1)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multilabel(fn, average, multidim_average, ignore_index):
    arrays = multilabel_inputs(205, samplewise=multidim_average == "samplewise", logits=True,
                               ignore_index=ignore_index)
    run_both(f"multilabel_{fn}", arrays, num_labels=L, average=average, multidim_average=multidim_average,
             ignore_index=ignore_index)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("fn", FNS)
def test_task_dispatch(fn, task):
    arrays = {"binary": binary_inputs(206), "multiclass": multiclass_inputs(206), "multilabel": multilabel_inputs(206)}
    run_both(fn, arrays[task], task=task, num_classes=C, num_labels=L, average="macro")


# ------------------------------------------------------------------- exact match


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("labels", [False, True])
def test_multiclass_exact_match(labels, multidim_average, ignore_index):
    arrays = multiclass_inputs(207, samplewise=True, labels=labels, ignore_index=ignore_index)
    if labels:  # a third of the rows exactly right, so the count is not zero
        arrays[0][: N // 3] = np.where(arrays[1][: N // 3] < 0, 0, arrays[1][: N // 3])
    run_both("multiclass_exact_match", arrays, num_classes=C, multidim_average=multidim_average,
             ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multilabel_exact_match(multidim_average, ignore_index):
    preds, target = multilabel_inputs(208, samplewise=True, ignore_index=ignore_index)
    preds[: N // 3] = np.where(target[: N // 3] == 1, 0.9, 0.1)
    run_both("multilabel_exact_match", (preds, target), num_labels=L, multidim_average=multidim_average,
             ignore_index=ignore_index)


def test_exact_match_dispatch():
    run_both("exact_match", multiclass_inputs(209, samplewise=True, labels=True), task="multiclass", num_classes=C)
    run_both("exact_match", multilabel_inputs(209), task="multilabel", num_labels=L)
    with pytest.raises(ValueError):
        TF.exact_match(torch.zeros(4), torch.zeros(4, dtype=torch.int64), task="binary")


# ------------------------------------------------------------------- Dice (legacy API)


def _labels(seed, shape, c=C):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, shape), rng.integers(0, c, shape)


@pytest.mark.parametrize("ignore_index", [None, 0])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", "samples"])
def test_dice_multiclass_labels(average, ignore_index):
    run_both("dice", _labels(210, (N,)), average=average, num_classes=C, ignore_index=ignore_index)


@pytest.mark.parametrize("top_k", [None, 2])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_dice_multiclass_probabilities(average, top_k):
    preds, target = multiclass_inputs(211)
    run_both("dice", (preds, target), average=average, num_classes=C, top_k=top_k)


@pytest.mark.parametrize("ignore_index", [None, 1])
@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro", "none", "samples"])
def test_dice_multidim_multiclass(average, mdmc_average, ignore_index):
    """Label maps ``(N, E, E)``: the one-hot ``(N, C, X)`` path a segmentation evaluation takes."""
    run_both("dice", _labels(212, (N // 4, E, E)), average=average, mdmc_average=mdmc_average, num_classes=C,
             ignore_index=ignore_index)


def test_dice_infers_the_class_count():
    """``num_classes=None`` under ``average="micro"``: the count comes from a host read of the labels' maximum."""
    run_both("dice", _labels(213, (N // 4, E, E)), average="micro", mdmc_average="global")


@pytest.mark.parametrize("average", ["micro", "samples"])
def test_dice_binary_and_multilabel(average):
    run_both("dice", binary_inputs(214), average=average)
    run_both("dice", multilabel_inputs(214), average=average)
    run_both("dice", multilabel_inputs(215), average="macro", num_classes=L)


def test_dice_zero_division_and_absent_classes():
    """A class never present under macro drops out; under none it is NaN; 0/0 micro takes ``zero_division``."""
    preds, target = np.array([0, 0, 1, 1]), np.array([0, 1, 1, 1])
    for average in ("macro", "none", "weighted"):
        run_both("dice", (preds, target), average=average, num_classes=C)
    run_both("dice", (np.zeros(4, np.int64), np.zeros(4, np.int64)), average="micro", num_classes=C,
             ignore_index=0, zero_division=1.0)


def test_dice_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="number of classes"):
        TF.dice(torch.tensor([0, 1]), torch.tensor([0, 1]), average="macro")
    with pytest.raises(ValueError, match="mdmc"):
        TF.dice(torch.zeros(2, 3, dtype=torch.int64), torch.zeros(2, 3, dtype=torch.int64), mdmc_average=None)
    with pytest.raises(ValueError, match="average"):
        TC.Dice(average="weighted", num_classes=C, device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        TC.Dice(average="none", num_classes=C, device="cpu")


# ------------------------------------------------------------------- classes

CLASSES = {
    "BinarySpecificity": ({"multidim_average": "samplewise"}, lambda s: binary_inputs(s, samplewise=True)),
    "MulticlassSpecificity": ({"num_classes": C, "average": "weighted", "ignore_index": -1},
                              lambda s: multiclass_inputs(s, ignore_index=-1)),
    "MultilabelSpecificity": ({"num_labels": L, "average": "none"}, lambda s: multilabel_inputs(s, logits=True)),
    "BinaryHammingDistance": ({"ignore_index": -1}, lambda s: binary_inputs(s, ignore_index=-1)),
    "MulticlassHammingDistance": ({"num_classes": C, "top_k": 2}, lambda s: multiclass_inputs(s)),
    "MultilabelHammingDistance": ({"num_labels": L, "multidim_average": "samplewise", "average": "micro"},
                                  lambda s: multilabel_inputs(s, samplewise=True)),
    "MulticlassExactMatch": ({"num_classes": C}, lambda s: multiclass_inputs(s, samplewise=True, labels=True)),
    "MulticlassExactMatch_samplewise": ({"num_classes": C, "multidim_average": "samplewise", "ignore_index": -1},
                                        lambda s: multiclass_inputs(s, samplewise=True, ignore_index=-1)),
    "MultilabelExactMatch": ({"num_labels": L}, lambda s: multilabel_inputs(s)),
    "MultilabelExactMatch_samplewise": ({"num_labels": L, "multidim_average": "samplewise"},
                                        lambda s: multilabel_inputs(s, samplewise=True)),
    "Dice": ({"num_classes": C, "average": "macro", "mdmc_average": "global"},
             lambda s: _labels(s, (N // 4, E, E))),
    "Dice_micro": ({"num_classes": C, "ignore_index": 0}, lambda s: _labels(s, (N,))),
    "Dice_samplewise": ({"num_classes": C, "average": "macro", "mdmc_average": "samplewise"},
                        lambda s: _labels(s, (N // 4, E, E))),
    "Dice_samples": ({"average": "samples"}, lambda s: multilabel_inputs(s)),
}


@pytest.mark.parametrize("config", sorted(CLASSES))
def test_class_stream(config):
    """Four batches, alternating ``forward`` and ``update``: each batch value and the final ``compute``."""
    kwargs, make = CLASSES[config]
    stream_pair(config.split("_")[0], kwargs, make)


def test_exact_match_states():
    """int32 sums under global, ``cat`` lists (ring buffers with a capacity) under samplewise.

    A ring buffer of capacity ``2 N`` after three batches of ``N`` holds the last two; the JAX
    package's exact match cannot take one (its update adds to the buffer as to a tensor), so the
    reference here is its list-state metric fed those two batches, compared as sorted values.
    """
    glob = TC.MultilabelExactMatch(num_labels=L, device="cpu")
    glob.update(*[torch.from_numpy(a) for a in multilabel_inputs(216)])
    assert glob.correct.dtype == torch.int32 and glob.total.dtype == torch.int32 and int(glob.total) == N
    ring = TC.MulticlassExactMatch(num_classes=C, multidim_average="samplewise", cat_state_capacity=2 * N,
                                   device="cpu")
    jm = JC.MulticlassExactMatch(num_classes=C, multidim_average="samplewise", auto_compile=False)
    for s in range(3):
        arrays = multiclass_inputs(217 + s, samplewise=True, labels=True)
        arrays[0][: N // 2] = arrays[1][: N // 2]
        ring.update(*[torch.from_numpy(a) for a in arrays])
        if s:
            jm.update(*[jnp.asarray(a) for a in arrays])
    assert type(ring.correct).__name__ == "RingBuffer" and len(ring.correct) == 2 * N
    # per-sample values; the buffer holds its rows in storage order, not in arrival order
    assert_tree(torch.sort(ring.compute()).values, np.sort(np.asarray(jm.compute())))


def test_samplewise_stat_scores_in_ring_buffers():
    """``multidim_average="samplewise"`` with ``cat_state_capacity``: the tp/fp/tn/fn states are ring buffers.

    The update used to add a batch to a ring buffer as to a tensor (the JAX package's stat scores still do).
    With room for every sample the per-sample values equal the JAX package's list-state metric.
    """
    kwargs = {"num_classes": C, "average": "macro", "multidim_average": "samplewise"}
    tm = TC.MulticlassSpecificity(device="cpu", cat_state_capacity=3 * N, **kwargs)
    jm = JC.MulticlassSpecificity(auto_compile=False, **kwargs)
    for s in range(3):
        arrays = multiclass_inputs(220 + s, samplewise=True, labels=True)
        tm.update(*[torch.from_numpy(a) for a in arrays])
        jm.update(*[jnp.asarray(a) for a in arrays])
    assert type(tm.tp).__name__ == "RingBuffer" and len(tm.tp) == 3 * N
    assert_tree(tm.compute(), jm.compute())


@pytest.mark.parametrize(
    ("wrapper", "kwargs", "expected"),
    [
        ("Specificity", {"task": "multiclass", "num_classes": C}, "MulticlassSpecificity"),
        ("HammingDistance", {"task": "multilabel", "num_labels": L}, "MultilabelHammingDistance"),
        ("ExactMatch", {"task": "multiclass", "num_classes": C}, "MulticlassExactMatch"),
        ("ExactMatch", {"task": "multilabel", "num_labels": L}, "MultilabelExactMatch"),
    ],
)
def test_task_wrappers(wrapper, kwargs, expected):
    metric = getattr(TC, wrapper)(device="cpu", **kwargs)
    assert type(metric).__name__ == expected and metric.device == torch.device("cpu")
