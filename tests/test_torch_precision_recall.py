"""Precision, recall, F-beta and F1 of the port against the JAX package, on the CPU.

The same seeded numpy inputs go through ``torchmetrics_tpu``'s functionals and
classes (JAX on the CPU) and ``torchmetrics_tpu_torch``'s (CPU tensors). The
tolerances are those of ``test_torch_classification.py``: counts exact,
ratios ``atol=1e-6, rtol=1e-5`` (the float32 rounding of one division and a
short sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch.classification as TC

from tests.test_torch_classification import C, L, assert_same, binary_inputs, multiclass_inputs, multilabel_inputs, run_both

FNS = ["precision", "recall", "fbeta_score", "f1_score"]
AVERAGES = ["micro", "macro", "weighted", "none"]


def _beta(fn):
    return {"beta": 2.0} if fn == "fbeta_score" else {}


@pytest.mark.parametrize("zero_division", [0.0, 1.0])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("fn", FNS)
def test_binary(fn, multidim_average, ignore_index, zero_division):
    arrays = binary_inputs(11, samplewise=multidim_average == "samplewise", logits=True, ignore_index=ignore_index)
    run_both(f"binary_{fn}", arrays, multidim_average=multidim_average, ignore_index=ignore_index,
             zero_division=zero_division, **_beta(fn))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multiclass(fn, average, top_k, ignore_index):
    arrays = multiclass_inputs(12, ignore_index=ignore_index)
    run_both(f"multiclass_{fn}", arrays, num_classes=C, average=average, top_k=top_k, ignore_index=ignore_index,
             **_beta(fn))


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multiclass_samplewise_labels(fn, average):
    arrays = multiclass_inputs(13, samplewise=True, labels=True)
    run_both(f"multiclass_{fn}", arrays, num_classes=C, average=average, multidim_average="samplewise", **_beta(fn))


@pytest.mark.parametrize("zero_division", [0.0, 1.0])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multiclass_zero_division(fn, average, zero_division):
    """Class C-1 is never predicted and class C-2 never the target: both divisions meet a zero."""
    rng = np.random.default_rng(14)
    preds = rng.integers(0, C - 1, 48)
    target = rng.integers(0, C - 2, 48)
    run_both(f"multiclass_{fn}", (preds, target), num_classes=C, average=average, zero_division=zero_division,
             **_beta(fn))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fn", FNS)
def test_multilabel(fn, average, multidim_average, ignore_index):
    arrays = multilabel_inputs(15, samplewise=multidim_average == "samplewise", ignore_index=ignore_index)
    run_both(f"multilabel_{fn}", arrays, num_labels=arrays[0].shape[1], average=average,
             multidim_average=multidim_average, ignore_index=ignore_index, **_beta(fn))


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("fn", FNS)
def test_task_dispatch(fn, task):
    arrays = {"binary": binary_inputs(16), "multiclass": multiclass_inputs(16), "multilabel": multilabel_inputs(16)}[task]
    run_both(fn, arrays, task=task, num_classes=C, num_labels=L, **_beta(fn))


CLASSES = {
    "BinaryPrecision": ({"zero_division": 1.0}, lambda s: binary_inputs(s)),
    "BinaryRecall": ({"ignore_index": -1}, lambda s: binary_inputs(s, ignore_index=-1)),
    "BinaryFBetaScore": ({"beta": 0.5}, lambda s: binary_inputs(s, logits=True)),
    "BinaryF1Score": ({"multidim_average": "samplewise"}, lambda s: binary_inputs(s, samplewise=True)),
    "MulticlassPrecision": ({"num_classes": C, "average": "weighted", "top_k": 2}, lambda s: multiclass_inputs(s)),
    "MulticlassRecall": ({"num_classes": C, "average": None, "ignore_index": -1},
                         lambda s: multiclass_inputs(s, ignore_index=-1)),
    "MulticlassFBetaScore": ({"num_classes": C, "beta": 2.0, "average": "micro"}, lambda s: multiclass_inputs(s)),
    "MulticlassF1Score": ({"num_classes": C}, lambda s: multiclass_inputs(s, labels=True)),
    "MultilabelPrecision": ({"num_labels": L, "average": "micro"}, lambda s: multilabel_inputs(s)),
    "MultilabelRecall": ({"num_labels": L, "ignore_index": -1}, lambda s: multilabel_inputs(s, ignore_index=-1)),
    "MultilabelFBetaScore": ({"num_labels": L, "beta": 2.0, "average": "weighted"}, lambda s: multilabel_inputs(s)),
    "MultilabelF1Score": ({"num_labels": L, "average": None}, lambda s: multilabel_inputs(s, logits=True)),
}


@pytest.mark.parametrize("cls_name", sorted(CLASSES))
def test_class_stream(cls_name):
    """Four batches, alternating ``forward`` and ``update``: each batch value and the final ``compute``."""
    kwargs, make = CLASSES[cls_name]
    jm = getattr(JC, cls_name)(auto_compile=False, **kwargs)
    tm = getattr(TC, cls_name)(device="cpu", **kwargs)
    for b in range(4):
        arrays = make(40 + b)
        j_args, t_args = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
        if b % 2 == 0:
            assert_same(tm(*t_args), jm(*j_args))
        else:
            jm.update(*j_args)
            tm.update(*t_args)
    assert_same(tm.compute(), jm.compute())


@pytest.mark.parametrize(
    ("wrapper", "kwargs", "expected"),
    [
        ("Precision", {"task": "binary"}, "BinaryPrecision"),
        ("Recall", {"task": "multiclass", "num_classes": C}, "MulticlassRecall"),
        ("FBetaScore", {"task": "multilabel", "num_labels": L, "beta": 2.0}, "MultilabelFBetaScore"),
        ("F1Score", {"task": "multiclass", "num_classes": C}, "MulticlassF1Score"),
    ],
)
def test_task_wrappers(wrapper, kwargs, expected):
    metric = getattr(TC, wrapper)(device="cpu", **kwargs)
    assert type(metric).__name__ == expected and metric.device == torch.device("cpu")
    if "beta" in kwargs:
        assert metric.beta == kwargs["beta"]


def test_beta_is_validated():
    with pytest.raises(ValueError, match="beta"):
        TC.BinaryFBetaScore(beta=0.0, device="cpu")
    with pytest.raises(ValueError, match="beta"):
        TC.MulticlassFBetaScore(beta=2, num_classes=C, device="cpu")
