"""Average precision and the four operating points of the port against the JAX package, on the CPU.

Average precision, recall at fixed precision, precision at fixed recall,
specificity at sensitivity and sensitivity at specificity all read the
precision-recall curve's states (binned counts or the exact ``cat`` lists).
The scores take 6 values only (``test_torch_auroc.py``'s data), so many tie:
the operating points' tie breaks (highest recall, then highest precision)
and the ``1e6`` sentinel threshold are exercised. The same seeded numpy inputs
go through ``torchmetrics_tpu`` (JAX on the CPU; classes built with
``auto_compile=False``) and ``torchmetrics_tpu_torch`` (CPU tensors).
Tolerances: ``atol=1e-6, rtol=1e-6`` (float32 curves and one short sum; the
thresholds are the inputs' own values or the shared float32 grid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch.classification as TC
from torchmetrics_tpu_torch.utilities import state_from_jax

from tests.test_torch_auroc import C, L, THRESHOLDS, binary_data, multiclass_data, multilabel_data
from tests.test_torch_confmat_family import assert_tree, run_both, stream_pair

OPS = {
    "recall_at_fixed_precision": {"min_precision": 0.5},
    "precision_at_fixed_recall": {"min_recall": 0.5},
    "specificity_at_sensitivity": {"min_sensitivity": 0.5},
    "sensitivity_at_specificity": {"min_specificity": 0.5},
}


# each data-dependent shape (exact mode, an ignore_index filter) costs the JAX side a compile:
# the grids pair the options instead of crossing them all
@pytest.mark.parametrize(("logits", "ignore_index"), [(False, None), (True, -1)])
@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
def test_binary_average_precision(thresholds, logits, ignore_index):
    run_both("binary_average_precision", binary_data(301, logits, ignore_index), thresholds=THRESHOLDS[thresholds],
             ignore_index=ignore_index)


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("int", None), ("list", -1)])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_multiclass_average_precision(average, thresholds, ignore_index):
    run_both("multiclass_average_precision", multiclass_data(302, ignore_index), num_classes=C, average=average,
             thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("int", None), ("list", -1)])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multilabel_average_precision(average, thresholds, ignore_index):
    run_both("multilabel_average_precision", multilabel_data(303, ignore_index=ignore_index), num_labels=L,
             average=average, thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index)


def test_average_precision_of_a_class_without_positives():
    """A class never the target: its AP is NaN (``none``) and drops out of ``macro`` with a warning in both."""
    preds, target = multiclass_data(304)
    target = np.where(target == 2, 0, target)
    for average in ("none", "macro", "weighted"):
        run_both("multiclass_average_precision", (preds, target), num_classes=C, average=average)
    with pytest.warns(UserWarning, match="nan"):
        TC.MulticlassAveragePrecision(num_classes=C, device="cpu")(*[torch.from_numpy(a) for a in (preds, target)])


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_average_precision_dispatch(task):
    arrays = {"binary": binary_data(305), "multiclass": multiclass_data(305), "multilabel": multilabel_data(305)}
    run_both("average_precision", arrays[task], task=task, num_classes=C, num_labels=L, thresholds=11)


# ------------------------------------------------------------------- operating points


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", None), ("int", -1), ("list", None)])
@pytest.mark.parametrize("op", sorted(OPS))
def test_binary_operating_point(op, thresholds, ignore_index):
    run_both(f"binary_{op}", binary_data(306, ignore_index=ignore_index), thresholds=THRESHOLDS[thresholds],
             ignore_index=ignore_index, **OPS[op])


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("int", None)])
@pytest.mark.parametrize("op", sorted(OPS))
def test_multiclass_operating_point(op, thresholds, ignore_index):
    run_both(f"multiclass_{op}", multiclass_data(307, ignore_index), num_classes=C, thresholds=THRESHOLDS[thresholds],
             ignore_index=ignore_index, **OPS[op])


@pytest.mark.parametrize(("thresholds", "ignore_index"), [("exact", -1), ("list", None)])
@pytest.mark.parametrize("op", sorted(OPS))
def test_multilabel_operating_point(op, thresholds, ignore_index):
    run_both(f"multilabel_{op}", multilabel_data(308, ignore_index=ignore_index), num_labels=L,
             thresholds=THRESHOLDS[thresholds], ignore_index=ignore_index, **OPS[op])


@pytest.mark.parametrize("constraint", [0.0, 0.9, 1.0])
@pytest.mark.parametrize("op", sorted(OPS))
def test_operating_point_constraints(op, constraint):
    """Constraints no point meets (the ``1e6`` sentinel) and ones every point meets, on tied binned curves."""
    kwargs = {next(iter(OPS[op])): constraint}
    run_both(f"binary_{op}", binary_data(309), thresholds=11, **kwargs)
    run_both(f"multiclass_{op}", multiclass_data(309), num_classes=C, thresholds=11, **kwargs)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_operating_point_dispatch(op, task):
    arrays = {"binary": binary_data(310), "multiclass": multiclass_data(310), "multilabel": multilabel_data(310)}
    run_both(op, arrays[task], task=task, num_classes=C, num_labels=L, thresholds=7, **OPS[op])


# ------------------------------------------------------------------- classes

CLASSES = {
    "BinaryAveragePrecision": ({}, lambda s: binary_data(s, logits=True)),
    "BinaryAveragePrecision_binned": ({"thresholds": 11, "ignore_index": -1},
                                      lambda s: binary_data(s, ignore_index=-1)),
    "MulticlassAveragePrecision": ({"num_classes": C, "average": "weighted"}, lambda s: multiclass_data(s)),
    "MulticlassAveragePrecision_binned": ({"num_classes": C, "thresholds": 11}, lambda s: multiclass_data(s)),
    "MultilabelAveragePrecision": ({"num_labels": L, "ignore_index": -1},
                                   lambda s: multilabel_data(s, ignore_index=-1)),
    "MultilabelAveragePrecision_binned": ({"num_labels": L, "thresholds": [0.1, 0.5, 0.9], "average": "micro"},
                                          lambda s: multilabel_data(s)),
    "BinaryRecallAtFixedPrecision": ({"min_precision": 0.5}, lambda s: binary_data(s)),
    "BinaryPrecisionAtFixedRecall": ({"min_recall": 0.5, "thresholds": 11}, lambda s: binary_data(s)),
    "BinarySpecificityAtSensitivity": ({"min_sensitivity": 0.5}, lambda s: binary_data(s, logits=True)),
    "BinarySensitivityAtSpecificity": ({"min_specificity": 0.5, "thresholds": 11}, lambda s: binary_data(s)),
    "MulticlassRecallAtFixedPrecision": ({"num_classes": C, "min_precision": 0.5, "thresholds": 11},
                                         lambda s: multiclass_data(s)),
    "MulticlassPrecisionAtFixedRecall": ({"num_classes": C, "min_recall": 0.5}, lambda s: multiclass_data(s)),
    "MulticlassSpecificityAtSensitivity": ({"num_classes": C, "min_sensitivity": 0.5, "thresholds": 11},
                                           lambda s: multiclass_data(s)),
    "MulticlassSensitivityAtSpecificity": ({"num_classes": C, "min_specificity": 0.5},
                                           lambda s: multiclass_data(s)),
    "MultilabelRecallAtFixedPrecision": ({"num_labels": L, "min_precision": 0.5}, lambda s: multilabel_data(s)),
    "MultilabelPrecisionAtFixedRecall": ({"num_labels": L, "min_recall": 0.5, "thresholds": 11},
                                         lambda s: multilabel_data(s)),
    "MultilabelSpecificityAtSensitivity": ({"num_labels": L, "min_sensitivity": 0.5, "ignore_index": -1},
                                           lambda s: multilabel_data(s, ignore_index=-1)),
    "MultilabelSensitivityAtSpecificity": ({"num_labels": L, "min_specificity": 0.5, "thresholds": 11},
                                           lambda s: multilabel_data(s)),
}


@pytest.mark.parametrize("config", sorted(CLASSES))
def test_class_stream(config):
    """Binned: four batches, alternating ``forward`` and ``update``, each batch value and the final ``compute``.

    Exact: two updates and the final ``compute``; each exact curve's data-dependent length costs the
    JAX side a compile, so the per-batch values of ``forward`` are left to the binned configurations.
    """
    kwargs, make = CLASSES[config]
    binned = "thresholds" in kwargs
    stream_pair(config.split("_")[0], kwargs, make, batches=4 if binned else 2, forward=binned)


@pytest.mark.parametrize(
    ("wrapper", "kwargs", "expected"),
    [
        ("AveragePrecision", {"task": "multilabel", "num_labels": L}, "MultilabelAveragePrecision"),
        ("RecallAtFixedPrecision", {"task": "binary", "min_precision": 0.5}, "BinaryRecallAtFixedPrecision"),
        ("PrecisionAtFixedRecall", {"task": "multiclass", "num_classes": C, "min_recall": 0.5},
         "MulticlassPrecisionAtFixedRecall"),
        ("SpecificityAtSensitivity", {"task": "multilabel", "num_labels": L, "min_sensitivity": 0.5},
         "MultilabelSpecificityAtSensitivity"),
        ("SensitivityAtSpecificity", {"task": "binary", "min_specificity": 0.5}, "BinarySensitivityAtSpecificity"),
    ],
)
def test_task_wrappers(wrapper, kwargs, expected):
    metric = getattr(TC, wrapper)(device="cpu", **kwargs)
    assert type(metric).__name__ == expected and metric.device == torch.device("cpu")


def test_binned_average_precision_state_from_jax():
    """A JAX binned AP's ``(T, C, 2, 2)`` counts, carried over with ``state_from_jax``, compute the same AP."""
    kwargs = {"num_classes": C, "thresholds": 11}
    jm = JC.MulticlassAveragePrecision(auto_compile=False, **kwargs)
    for s in range(3):
        jm.update(*[jnp.asarray(a) for a in multiclass_data(311 + s)])
    tm = TC.MulticlassAveragePrecision(device="cpu", **kwargs)
    tm.load_state_dict(state_from_jax(jm.state_dict(all_states=True), device="cpu"))
    assert tm.confmat.dtype == torch.int32 and tm.confmat.shape == (11, C, 2, 2)
    assert_tree(tm.compute(), jm.compute())
