"""The port's classification, image and text exports equal the JAX package's.

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
import torchmetrics_tpu_torch.functional.image as TFI
import torchmetrics_tpu_torch.functional.text as TFT
import torchmetrics_tpu_torch.image as TI
import torchmetrics_tpu_torch.text as TT

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


@pytest.mark.parametrize(("relpath", "module"), [("text/__init__.py", TT), ("functional/text/__init__.py", TFT)])
def test_text_all_equals_the_jax_package(relpath, module):
    want = _jax_all(relpath)
    assert len(want) == 16
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_text_names_reach_the_top_level():
    for name in TT.__all__:
        assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(TT, name)
    for name in TFT.__all__:
        assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(TFT, name)


@pytest.mark.parametrize(
    ("relpath", "module", "count"), [("image/__init__.py", TI, 21), ("functional/image/__init__.py", TFI, 18)]
)
def test_image_all_equals_the_jax_package(relpath, module, count):
    want = _jax_all(relpath)
    assert len(want) == count
    assert sorted(module.__all__) == sorted(want)
    assert not [name for name in want if not hasattr(module, name)]


def test_image_names_reach_the_top_level():
    for name in TI.__all__:
        assert name in torchmetrics_tpu_torch.__all__ and getattr(torchmetrics_tpu_torch, name) is getattr(TI, name)
    for name in TFI.__all__:
        assert name in TF_ALL.__all__ and getattr(TF_ALL, name) is getattr(TFI, name)
    # as in the JAX package, `functional.image` re-exports the PPL function of `image/`
    from torchmetrics_tpu_torch.image.perceptual_path_length import perceptual_path_length

    assert TFI.perceptual_path_length is perceptual_path_length


def test_new_classes_default_to_cuda():
    """Built without ``device=``, a metric keeps its states on ``cuda``: where there is no GPU it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for make in (lambda: TC.MulticlassJaccardIndex(num_classes=3), lambda: TC.Dice(),
                 lambda: TC.BinaryCalibrationError(), lambda: TC.MultilabelRankingLoss(num_labels=3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
