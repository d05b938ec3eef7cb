"""The nine classification golden cases replayed through the port's functionals.

``tests/goldens/goldens.npz`` holds values frozen from the original
torchmetrics over the seeded inputs of ``tests/helpers/golden_specs.py``.
Replaying the stat-scores/accuracy/confusion-matrix cases through
``torchmetrics_tpu_torch`` holds the port to torchmetrics itself, not only to
the JAX package, at each spec's own ``atol`` (and ``rtol=1e-4``, as the JAX
package's replay in ``tests/unittests/test_goldens.py``).
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
CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in PORTED]


def test_all_nine_cases_are_in_the_pack():
    assert sorted(spec.fn for _, spec in CASES) == sorted(PORTED)


@pytest.mark.parametrize(("case_id", "spec"), CASES, ids=[c[0] for c in CASES])
def test_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref" and meta["n_leaves"] == 1
    out = getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **spec.kwargs)
    golden = pack[f"{case_id}/0"]
    assert out.shape == golden.shape
    np.testing.assert_allclose(
        out.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4, err_msg=case_id
    )
