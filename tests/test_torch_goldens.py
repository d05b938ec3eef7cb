"""The classification golden cases replayed through the port's functionals.

``tests/goldens/goldens.npz`` holds values frozen from the original
torchmetrics over the seeded inputs of ``tests/helpers/golden_specs.py``.
Replaying the stat-scores/accuracy/confusion-matrix cases and those of the
precision/recall/F-beta/F1, precision-recall curve, ROC and AUROC families
through ``torchmetrics_tpu_torch`` holds the port to torchmetrics itself, not
only to the JAX package, at each spec's own ``atol`` (and ``rtol=1e-4``, as the
JAX package's replay in ``tests/unittests/test_goldens.py``). A curve's output
is several leaves (``/0`` .. ``/k`` in the pack: precision, recall and
thresholds, per class for the multiclass and multilabel curves), flattened in
the order the JAX replay flattens them.
"""

import json
import os

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as TF

from tests.helpers.golden_specs import SPECS

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
PORTED = [
    f"{task}_{name}"
    for task in ("binary", "multiclass", "multilabel")
    for name in ("accuracy", "confusion_matrix", "stat_scores")
]
SLICE = [
    f"{task}_{name}"
    for task in ("binary", "multiclass", "multilabel")
    for name in ("precision", "recall", "fbeta_score", "f1_score", "precision_recall_curve", "roc", "auroc")
]
CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in PORTED + SLICE]
SLICE_IDS = ["001", "006", "011", "012", "015", "016", "017", "022", "024", "030", "035", "036", "039", "040", "041",
             "047", "052", "056", "057", "060", "061", "064"]


def test_all_nine_cases_are_in_the_pack():
    assert sorted(spec.fn for _, spec in CASES if spec.fn in PORTED) == sorted(PORTED)


def test_the_22_cases_of_the_slice_are_in_the_pack():
    assert sorted(case_id[:3] for case_id, spec in CASES if spec.fn in SLICE) == SLICE_IDS


def _flatten_output(out) -> list:
    if isinstance(out, (list, tuple)):
        return [leaf for item in out for leaf in _flatten_output(item)]
    return [out]


@pytest.mark.parametrize(("case_id", "spec"), CASES, ids=[c[0] for c in CASES])
def test_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref"
    leaves = _flatten_output(getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **spec.kwargs))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        assert leaf.shape == golden.shape, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
            err_msg=f"{case_id} leaf {li}",
        )
