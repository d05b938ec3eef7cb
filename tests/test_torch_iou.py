"""The port's IoU, GIoU, DIoU and CIoU (functional and class) on the CPU, against the JAX package.

The same seeded numpy boxes go through both packages: pairwise matrices and
aggregates agree within 1e-6, class results (with ``respect_labels``,
``iou_threshold`` and ``class_metrics``) within 1e-6, key for key. The IoU
matrix is also held to a float64 numpy loop within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.detection as JD
import torchmetrics_tpu.functional.detection as JF
import torchmetrics_tpu_torch.detection as PD
import torchmetrics_tpu_torch.functional.detection as PF
from torchmetrics_tpu.functional.detection._pairwise import box_convert as jax_box_convert
from torchmetrics_tpu_torch.functional.detection._pairwise import box_convert

FUNCTIONALS = ["intersection_over_union", "generalized_intersection_over_union",
               "distance_intersection_over_union", "complete_intersection_over_union"]
CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
           "CompleteIntersectionOverUnion"]


def _boxes(rng, n, scale=50.0):
    xy = rng.random((n, 2)).astype(np.float32) * scale
    return np.concatenate([xy, xy + rng.random((n, 2)).astype(np.float32) * 20 + 2], 1)


def _float64_iou(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    lt, rb = np.maximum(a[:, None, :2], b[None, :, :2]), np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


@pytest.mark.parametrize("name", FUNCTIONALS)
@pytest.mark.parametrize(("threshold", "aggregate"), [(None, True), (None, False), (0.3, False)])
def test_functional_matches_jax(name, threshold, aggregate):
    rng = np.random.default_rng(len(name))
    preds, target = _boxes(rng, 7), _boxes(rng, 5)
    kw = dict(iou_threshold=threshold, replacement_val=-0.5, aggregate=aggregate)
    want = getattr(JF, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = getattr(PF, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_iou_matrix_matches_float64():
    rng = np.random.default_rng(0)
    preds, target = _boxes(rng, 16), _boxes(rng, 16)
    got = PF.intersection_over_union(torch.from_numpy(preds), torch.from_numpy(target), aggregate=False)
    np.testing.assert_allclose(got.numpy(), _float64_iou(preds, target), rtol=0, atol=1e-6)


@pytest.mark.parametrize(("fmt_in", "fmt_out"), [("xywh", "xyxy"), ("cxcywh", "xyxy"), ("xyxy", "cxcywh"),
                                                 ("xyxy", "xywh")])
def test_box_convert_matches_jax(fmt_in, fmt_out):
    boxes = _boxes(np.random.default_rng(1), 6)
    want = jax_box_convert(jnp.asarray(boxes), fmt_in, fmt_out)
    np.testing.assert_allclose(box_convert(torch.from_numpy(boxes), fmt_in, fmt_out).numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def _dataset(seed, n_img=2, n_cls=3):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n_img):
        n, m = int(rng.integers(0, 6)), int(rng.integers(0, 5))
        preds.append(dict(boxes=_boxes(rng, n), labels=rng.integers(0, n_cls, n), scores=rng.random(n)))
        target.append(dict(boxes=_boxes(rng, m), labels=rng.integers(0, n_cls, m)))
    return preds, target


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("kw", [dict(), dict(respect_labels=False), dict(iou_threshold=0.2, class_metrics=True),
                                dict(class_metrics=True, box_format="xywh")], ids=["default", "any_label",
                                                                                   "threshold_classes", "xywh"])
def test_class_matches_jax(name, kw):
    jm, pm = getattr(JD, name)(**kw), getattr(PD, name)(device="cpu", **kw)
    for seed in (5, 6):
        preds, target = _dataset(seed)
        jm.update([{k: jnp.asarray(v) for k, v in d.items()} for d in preds],
                  [{k: jnp.asarray(v) for k, v in d.items()} for d in target])
        pm.update([{k: torch.as_tensor(v) for k, v in d.items()} for d in preds],
                  [{k: torch.as_tensor(v) for k, v in d.items()} for d in target])
    want, got = jm.compute(), pm.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=0, atol=1e-6, err_msg=key)


def test_class_without_updates_and_bad_arguments():
    assert float(PD.IntersectionOverUnion(device="cpu").compute()["iou"]) == float(JD.IntersectionOverUnion().compute()["iou"])
    for kw in (dict(box_format="xyxyx"), dict(class_metrics=1), dict(respect_labels="yes")):
        with pytest.raises(ValueError):
            PD.IntersectionOverUnion(device="cpu", **kw)
