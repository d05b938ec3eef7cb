"""Calibration error, hinge loss, the multilabel ranking metrics and group fairness of the port
against the JAX package, on the CPU.

The same seeded numpy inputs go through ``torchmetrics_tpu`` (JAX on the CPU;
classes built with ``auto_compile=False``) and ``torchmetrics_tpu_torch`` (CPU
tensors, ``device="cpu"``). Tolerances: counts exact; float values
``atol=1e-6, rtol=1e-6`` (float32 per-bin sums over at most a few hundred
samples, added in another order by ``index_add_`` than by XLA's segment sum;
float32 loss sums; pairwise rank counts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.functional.classification as TF
from torchmetrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries
from torchmetrics_tpu_torch.utilities import state_from_jax

from tests.test_torch_classification import C, E, L, N, binary_inputs, multiclass_inputs, multilabel_inputs
from tests.test_torch_confmat_family import assert_tree, run_both, stream_pair


# ------------------------------------------------------------------- calibration error


@pytest.mark.parametrize("n_bins", [1, 10, 15, 100])
def test_bin_boundaries_are_jax_linspace(n_bins):
    """The grid is ``jax.numpy.linspace``'s float32 values bit for bit, which ``torch.linspace`` is not."""
    np.testing.assert_array_equal(_bin_boundaries(n_bins).numpy(),
                                  np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32)))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("logits", [False, True])
def test_binary_calibration_error(logits, norm, ignore_index):
    run_both("binary_calibration_error", binary_inputs(401, logits=logits, ignore_index=ignore_index), n_bins=10,
             norm=norm, ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("probabilities", [False, True])
def test_multiclass_calibration_error(probabilities, norm, ignore_index):
    preds, target = multiclass_inputs(402, ignore_index=ignore_index)
    if probabilities:  # in [0, 1]: no softmax
        preds = np.exp(preds) / np.exp(preds).sum(1, keepdims=True)
    run_both("multiclass_calibration_error", (preds.astype(np.float32), target), num_classes=C, n_bins=15, norm=norm,
             ignore_index=ignore_index)


def test_calibration_confidences_on_bin_boundaries():
    """Confidences equal to a boundary of the float32 grid go to the bin on their right, as in the JAX package."""
    edges = np.asarray(jnp.linspace(0, 1, 16, dtype=jnp.float32))
    preds = np.concatenate([edges, edges[1:-1]]).astype(np.float32)
    target = (np.arange(preds.shape[0]) % 2).astype(np.int64)
    for norm in ("l1", "max"):
        run_both("binary_calibration_error", (preds, target), n_bins=15, norm=norm)


def test_calibration_l2_of_a_perfect_calibration_is_zero():
    preds = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    target = np.array([0, 0, 1, 1])
    run_both("binary_calibration_error", (preds, target), norm="l2")
    assert float(TF.binary_calibration_error(torch.from_numpy(preds), torch.from_numpy(target), norm="l2")) == 0.0


def test_calibration_dispatch():
    run_both("calibration_error", binary_inputs(403), task="binary", n_bins=5)
    run_both("calibration_error", multiclass_inputs(403), task="multiclass", num_classes=C, norm="max")


# ------------------------------------------------------------------- hinge loss


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("logits", [False, True])
def test_binary_hinge_loss(logits, squared, ignore_index):
    run_both("binary_hinge_loss", binary_inputs(404, logits=logits, ignore_index=ignore_index), squared=squared,
             ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("multiclass_mode", ["crammer-singer", "one-vs-all"])
def test_multiclass_hinge_loss(multiclass_mode, squared, ignore_index):
    run_both("multiclass_hinge_loss", multiclass_inputs(405, ignore_index=ignore_index), num_classes=C,
             squared=squared, multiclass_mode=multiclass_mode, ignore_index=ignore_index)


def test_multiclass_hinge_loss_on_maps():
    """``(N, C, E)`` scores with ``(N, E)`` targets: moved to ``(N*E, C)`` rows as in the JAX package."""
    run_both("multiclass_hinge_loss", multiclass_inputs(406, samplewise=True), num_classes=C)


def test_hinge_dispatch():
    run_both("hinge_loss", binary_inputs(407), task="binary")
    run_both("hinge_loss", multiclass_inputs(407), task="multiclass", num_classes=C, multiclass_mode="one-vs-all")


# ------------------------------------------------------------------- ranking


def _ranking_inputs(seed, ties=False, ignore_index=None):
    rng = np.random.default_rng(seed)
    preds = (rng.integers(0, 4, (N, L)) / 4).astype(np.float32) if ties else rng.random((N, L)).astype(np.float32)
    target = rng.integers(0, 2, (N, L))
    target[0] = 0  # a row without a relevant label
    target[1] = 1  # a row of relevant labels only
    if ignore_index is not None:
        target[rng.random((N, L)) < 0.05] = ignore_index
    return preds, target


@pytest.mark.parametrize(("ties", "ignore_index"), [(False, None), (True, None), (True, -1)])
@pytest.mark.parametrize("name", ["multilabel_coverage_error", "multilabel_ranking_average_precision",
                                  "multilabel_ranking_loss"])
def test_ranking(name, ties, ignore_index):
    run_both(name, _ranking_inputs(408, ties, ignore_index), num_labels=L, ignore_index=ignore_index)


@pytest.mark.parametrize("name", ["multilabel_coverage_error", "multilabel_ranking_average_precision",
                                  "multilabel_ranking_loss"])
def test_ranking_of_logits_on_maps(name):
    """Logits (a sigmoid first) of shape ``(N, L, E)``: moved to ``(N*E, L)`` rows."""
    preds, target = multilabel_inputs(409, samplewise=True, logits=True)
    run_both(name, (preds, target), num_labels=L)


# ------------------------------------------------------------------- group fairness


def _fairness_inputs(seed, groups=2, ignore_index=None):
    preds, target = binary_inputs(seed, ignore_index=ignore_index)
    return preds, target, np.random.default_rng(seed + 1).integers(0, groups, N)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("groups", [2, 4])
def test_binary_groups_stat_rates(groups, ignore_index):
    run_both("binary_groups_stat_rates", _fairness_inputs(410, groups, ignore_index), num_groups=groups,
             ignore_index=ignore_index)


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
@pytest.mark.parametrize("groups", [2, 4])
def test_binary_fairness(groups, task):
    run_both("binary_fairness", _fairness_inputs(411, groups), task=task)


@pytest.mark.parametrize("groups", [2, 3])
def test_demographic_parity_and_equal_opportunity(groups):
    preds, target, group_ids = _fairness_inputs(412, groups)
    run_both("demographic_parity", (preds, group_ids))
    run_both("equal_opportunity", (preds, target, group_ids))


def test_groups_are_validated():
    preds, target, _ = _fairness_inputs(413)
    with pytest.raises(ValueError, match="groups"):
        TF.binary_groups_stat_rates(torch.from_numpy(preds), torch.from_numpy(target), torch.full((N,), 5), 2)
    with pytest.raises(ValueError, match="int"):
        TF.binary_groups_stat_rates(torch.from_numpy(preds), torch.from_numpy(target), torch.zeros(N), 2)


# ------------------------------------------------------------------- classes

CLASSES = {
    "BinaryCalibrationError": ({"n_bins": 10, "ignore_index": -1}, lambda s: binary_inputs(s, ignore_index=-1)),
    "MulticlassCalibrationError": ({"num_classes": C, "norm": "max"}, lambda s: multiclass_inputs(s)),
    "MulticlassCalibrationError_l2": ({"num_classes": C, "norm": "l2"}, lambda s: multiclass_inputs(s)),
    "BinaryHingeLoss": ({"squared": True}, lambda s: binary_inputs(s, logits=True)),
    "MulticlassHingeLoss": ({"num_classes": C}, lambda s: multiclass_inputs(s)),
    "MulticlassHingeLoss_ova": ({"num_classes": C, "multiclass_mode": "one-vs-all", "ignore_index": -1},
                                lambda s: multiclass_inputs(s, ignore_index=-1)),
    "MultilabelCoverageError": ({"num_labels": L}, lambda s: _ranking_inputs(s, ties=True)),
    "MultilabelRankingAveragePrecision": ({"num_labels": L, "ignore_index": -1},
                                          lambda s: _ranking_inputs(s, ties=True, ignore_index=-1)),
    "MultilabelRankingLoss": ({"num_labels": L}, lambda s: _ranking_inputs(s)),
    "BinaryGroupStatRates": ({"num_groups": 4}, lambda s: _fairness_inputs(s, 4)),
    "BinaryFairness": ({"num_groups": 2}, lambda s: _fairness_inputs(s, 2)),
    "BinaryFairness_dp": ({"num_groups": 3, "task": "demographic_parity"}, lambda s: _fairness_inputs(s, 3)),
}


@pytest.mark.parametrize("config", sorted(CLASSES))
def test_class_stream(config):
    """Four batches, alternating ``forward`` and ``update``: each batch value and the final ``compute``."""
    kwargs, make = CLASSES[config]
    stream_pair(config.split("_")[0], kwargs, make)


@pytest.mark.parametrize(
    ("wrapper", "kwargs", "expected"),
    [
        ("CalibrationError", {"task": "binary"}, "BinaryCalibrationError"),
        ("CalibrationError", {"task": "multiclass", "num_classes": C}, "MulticlassCalibrationError"),
        ("HingeLoss", {"task": "multiclass", "num_classes": C, "multiclass_mode": "one-vs-all"},
         "MulticlassHingeLoss"),
    ],
)
def test_task_wrappers(wrapper, kwargs, expected):
    metric = getattr(TC, wrapper)(device="cpu", **kwargs)
    assert type(metric).__name__ == expected and metric.device == torch.device("cpu")


def test_calibration_cat_state_from_jax():
    """A JAX calibration metric's ``cat`` lists, carried over with ``state_from_jax``, bin to the same error."""
    jm = JC.MulticlassCalibrationError(num_classes=C, n_bins=15, auto_compile=False)
    for s in range(3):
        jm.update(*[jnp.asarray(a) for a in multiclass_inputs(414 + s)])
    tm = TC.MulticlassCalibrationError(num_classes=C, n_bins=15, device="cpu")
    tm.load_state_dict(state_from_jax(jm.state_dict(all_states=True), device="cpu"))
    assert isinstance(tm.confidences, list) and len(tm.confidences) == 3
    assert_tree(tm.compute(), jm.compute())
    arrays = multiclass_inputs(417)
    jm.update(*[jnp.asarray(a) for a in arrays])
    tm.update(*[torch.from_numpy(a) for a in arrays])
    assert_tree(tm.compute(), jm.compute())


def test_hinge_and_ranking_states_are_float32_sums():
    hinge = TC.MulticlassHingeLoss(num_classes=C, multiclass_mode="one-vs-all", device="cpu")
    hinge.update(*[torch.from_numpy(a) for a in multiclass_inputs(418)])
    assert hinge.measures.shape == (C,) and hinge.measures.dtype == torch.float32 and float(hinge.total) == N
    ranking = TC.MultilabelRankingLoss(num_labels=L, device="cpu")
    ranking.update(*[torch.from_numpy(a) for a in multilabel_inputs(418, samplewise=True)])
    assert ranking.measure.dtype == torch.float32 and float(ranking.total) == N * E
