"""The port's classification exports equal the JAX package's.

The JAX package's ``__all__`` lists are read from its source with ``ast``, so
nothing of it is imported next to the port here.
"""

import ast
import os

import pytest

import torchmetrics_tpu_torch
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.functional as TF_ALL
import torchmetrics_tpu_torch.functional.classification as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_all(relpath):
    with open(os.path.join(ROOT, "torchmetrics_tpu", relpath)) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no literal __all__ in {relpath}")


@pytest.mark.parametrize(
    ("relpath", "module", "count"),
    [("classification/__init__.py", TC, 94), ("functional/classification/__init__.py", TF, 96)],
)
def test_classification_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    missing = [name for name in want if not hasattr(module, name)]
    assert not missing, missing


def test_classification_names_reach_the_top_level():
    assert set(TC.__all__) <= set(torchmetrics_tpu_torch.__all__)
    assert set(TF.__all__) <= set(TF_ALL.__all__)
    for name in TC.__all__:
        assert getattr(torchmetrics_tpu_torch, name) is getattr(TC, name)
    for name in TF.__all__:
        assert getattr(TF_ALL, name) is getattr(TF, name)


def test_new_classes_default_to_cuda():
    """Built without ``device=``, a metric keeps its states on ``cuda``: where there is no GPU it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for make in (lambda: TC.MulticlassJaccardIndex(num_classes=3), lambda: TC.Dice(),
                 lambda: TC.BinaryCalibrationError(), lambda: TC.MultilabelRankingLoss(num_labels=3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
