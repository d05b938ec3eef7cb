"""The port's MeanAveragePrecision and its COCO engine on the CPU, against the JAX package and the numpy oracles.

The same seeded numpy datasets go through ``torchmetrics_tpu.detection``
and ``torchmetrics_tpu_torch.detection`` (``device="cpu"``). Every key of
``compute()`` is held to the JAX package's within 1e-6, ``extended_summary``'s
precision/recall/scores arrays too; both matchers and ``evaluate_map`` are
held to the JAX functions directly. Against the repo's two independent numpy
references, ``coco_oracle.py`` and ``pycocotools_port.py``, the JAX suite's
own tolerances hold: 1e-5 for boxes, 1e-4 for masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.detection._map_eval as JM
import torchmetrics_tpu_torch.functional.detection._map_eval as PM
from tests.unittests.detection.coco_oracle import coco_eval_oracle
from tests.unittests.detection.pycocotools_port import eval_tm_format
from tests.unittests.detection.test_mean_ap import IOU_THRS, MAX_DETS, REC_THRS, _random_dataset
from torchmetrics_tpu.detection import MeanAveragePrecision as JaxMAP
from torchmetrics_tpu_torch.detection import MeanAveragePrecision

BOX_KEYS = ({"boxes", "scores", "labels"}, {"boxes", "labels", "iscrowd", "area"})
MASK_KEYS = ({"masks", "scores", "labels"}, {"masks", "labels", "iscrowd", "area"})
STATS = ["map", "map_50", "map_75", "map_small", "map_medium", "map_large",
         "mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large"]


def _jnp(dicts, keys):
    return [{k: jnp.asarray(v) for k, v in d.items() if k in keys} for d in dicts]


def _torch(dicts, keys):
    return [{k: torch.as_tensor(np.asarray(v)) for k, v in d.items() if k in keys} for d in dicts]


def _mask_dataset(seed, n_img=4, side=(24, 32), n_cls=2, crowd_p=0.0):
    rng = np.random.default_rng(seed)
    h, w = side

    def masks(n):
        out = np.zeros((n, h, w), bool)
        for k in range(n):
            x, y = rng.integers(0, w - 8), rng.integers(0, h - 8)
            mw, mh = rng.integers(3, 12, 2)
            out[k, y : y + mh, x : x + mw] = True
        return out

    preds, targets = [], []
    for _ in range(n_img):
        nd, ng = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        preds.append(dict(masks=masks(nd), scores=np.round(rng.random(nd), 2), labels=rng.integers(0, n_cls, nd)))
        targets.append(dict(masks=masks(ng), labels=rng.integers(0, n_cls, ng),
                            iscrowd=(rng.random(ng) < crowd_p).astype(int)))
    return preds, targets


def _both(preds, targets, keys, **kw):
    """compute() of the JAX package's metric and the port's on the same data, as numpy."""
    jm, pm = JaxMAP(**kw), MeanAveragePrecision(device="cpu", **kw)
    jm.update(_jnp(preds, keys[0]), _jnp(targets, keys[1]))
    pm.update(_torch(preds, keys[0]), _torch(targets, keys[1]))
    return ({k: np.asarray(v) for k, v in jm.compute().items()},
            {k: v.cpu().numpy() for k, v in pm.compute().items()})


def _assert_same(want, got, atol=1e-6):
    assert set(want) == set(got), set(want) ^ set(got)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("with_area", [False, True])
def test_bbox_matches_jax(seed, with_area, average):
    preds, targets = _random_dataset(seed, with_area=with_area)
    _assert_same(*_both(preds, targets, BOX_KEYS, average=average))


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("seed", range(2))
def test_segm_matches_jax(seed, average):
    preds, targets = _mask_dataset(seed, crowd_p=0.2)
    _assert_same(*_both(preds, targets, MASK_KEYS, iou_type="segm", average=average))


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_class_metrics_and_extended_summary_match_jax(iou_type, average):
    preds, targets = _random_dataset(11) if iou_type == "bbox" else _mask_dataset(11)
    keys = BOX_KEYS if iou_type == "bbox" else MASK_KEYS
    want, got = _both(preds, targets, keys, iou_type=iou_type, average=average, class_metrics=True,
                      extended_summary=True)
    _assert_same(want, got)
    n_cls = got["classes"].size
    assert got["map_per_class"].shape == (n_cls,) and got["mar_100_per_class"].shape == (n_cls,)
    t, r, c, a, m = got["precision"].shape
    assert (t, r, a, m) == (10, 101, 4, 3) and c >= n_cls and got["recall"].shape == (t, c, a, m)
    assert got["scores"].shape == got["precision"].shape


def test_custom_thresholds_match_jax():
    preds, targets = _random_dataset(12)
    want, got = _both(preds, targets, BOX_KEYS, iou_thresholds=[0.4, 0.6], rec_thresholds=[0.0, 0.25, 0.5, 1.0],
                      max_detection_thresholds=[2, 5], class_metrics=True)
    _assert_same(want, got)
    assert float(got["map_50"]) == -1.0 and float(got["map_75"]) == -1.0 and "mar_5" in got


def test_box_formats_match_jax():
    preds, targets = _random_dataset(14)
    for p in (*preds, *targets):
        p["boxes"] = np.concatenate([p["boxes"][:, :2], p["boxes"][:, 2:] - p["boxes"][:, :2]], 1)
    _assert_same(*_both(preds, targets, BOX_KEYS, box_format="xywh"))


def test_empty_update_then_merge_matches_jax():
    metric = MeanAveragePrecision(device="cpu")
    metric.update([], [])
    out = metric.compute()
    assert out["classes"].numel() == 0 and float(out["map"]) == -1.0
    jm = JaxMAP()
    jm.update([], [])
    _assert_same({k: np.asarray(v) for k, v in jm.compute().items()}, {k: v.numpy() for k, v in out.items()})

    # images without detections or ground truths, then a second metric merged in
    preds, targets = _random_dataset(21)
    preds[0] = dict(boxes=np.zeros((0, 4)), scores=np.zeros(0), labels=np.zeros(0, int))
    targets[1] = dict(boxes=np.zeros((0, 4)), labels=np.zeros(0, int), iscrowd=np.zeros(0, int))
    first, second = MeanAveragePrecision(device="cpu"), MeanAveragePrecision(device="cpu")
    first.update(_torch(preds[:3], BOX_KEYS[0]), _torch(targets[:3], BOX_KEYS[1]))
    second.update(_torch(preds[3:], BOX_KEYS[0]), _torch(targets[3:], BOX_KEYS[1]))
    first.merge_state(second)
    want, _ = _both(preds, targets, BOX_KEYS)
    _assert_same(want, {k: v.numpy() for k, v in first.compute().items()})


def test_sparse_large_label_ids_match_jax():
    preds, targets = _random_dataset(23)
    remap = np.array([1, 17, 90, 10**6])
    for p in (*preds, *targets):
        p["labels"] = remap[p["labels"]]
    want, got = _both(preds, targets, BOX_KEYS, class_metrics=True)
    _assert_same(want, got)
    assert set(got["classes"].tolist()) <= set(remap.tolist())


def test_mixed_iou_types_match_jax():
    rng = np.random.default_rng(3)
    preds, targets = _mask_dataset(5)
    for d in (*preds, *targets):
        n = d["masks"].shape[0]
        xy = rng.random((n, 2)) * 20
        d["boxes"] = np.concatenate([xy, xy + rng.random((n, 2)) * 30 + 2], 1)
    keys = (BOX_KEYS[0] | {"masks"}, BOX_KEYS[1] | {"masks"})
    want, got = _both(preds, targets, keys, iou_type=("bbox", "segm"))
    _assert_same(want, got)
    assert "bbox_map" in got and "segm_map" in got


@pytest.mark.parametrize("seed", range(2))
def test_bbox_matches_both_numpy_oracles(seed):
    preds, targets = _random_dataset(seed + 40, with_area=True)
    metric = MeanAveragePrecision(device="cpu")
    metric.update(_torch(preds, BOX_KEYS[0]), _torch(targets, BOX_KEYS[1]))
    got = {k: float(v) for k, v in metric.compute().items() if k in STATS}
    classes = sorted({int(c) for d in (*preds, *targets) for c in d["labels"]})
    p_ref, r_ref = coco_eval_oracle(preds, targets, IOU_THRS, REC_THRS, MAX_DETS, classes)
    first = JM.summarize(p_ref, r_ref, IOU_THRS, MAX_DETS)
    port = eval_tm_format(preds, targets)
    for key in STATS:
        assert abs(got[key] - first[key]) <= 1e-5, (key, got[key], first[key])
        assert abs(got[key] - port[key]) <= 1e-5, (key, got[key], port[key])


def test_segm_matches_both_numpy_oracles():
    preds, targets = _mask_dataset(7)
    metric = MeanAveragePrecision(iou_type="segm", device="cpu")
    metric.update(_torch(preds, MASK_KEYS[0]), _torch(targets, MASK_KEYS[1]))
    got = {k: float(v) for k, v in metric.compute().items() if k in STATS}
    p_ref, r_ref = coco_eval_oracle(preds, targets, IOU_THRS, REC_THRS, MAX_DETS, [0, 1], masks=True)
    first = JM.summarize(p_ref, r_ref, IOU_THRS, MAX_DETS)
    port = eval_tm_format(preds, targets, iou_type="segm")
    for key in STATS:
        assert abs(got[key] - first[key]) <= 1e-4, (key, got[key], first[key])
        assert abs(got[key] - port[key]) <= 1e-4, (key, got[key], port[key])


def _match_inputs(seed, num_i=6, num_d=20, num_g=8, num_c=4, num_t=3, num_a=2):
    rng = np.random.default_rng(seed)
    arrays = dict(
        iou=rng.uniform(0, 1, (num_i, num_d, num_g)).astype(np.float32),
        dl=rng.integers(0, num_c, (num_i, num_d)).astype(np.int32),
        dv=rng.random((num_i, num_d)) < 0.9,
        dia=rng.random((num_i, num_d, num_a)) < 0.2,
        gl=rng.integers(0, num_c, (num_i, num_g)).astype(np.int32),
        gv=rng.random((num_i, num_g)) < 0.9,
        gc=rng.random((num_i, num_g)) < 0.25,
        thr=np.sort(rng.uniform(0.2, 0.9, num_t)).astype(np.float32),
    )
    arrays["iou"][:, :, 3] = arrays["iou"][:, :, 5]  # equal IoUs: the later ground truth must win
    arrays["gig"] = (arrays["gc"][:, None, :] | (rng.random((num_i, num_a, num_g)) < 0.2)) & arrays["gv"][:, None, :]
    return arrays, num_c


@pytest.mark.parametrize("seed", range(3))
def test_both_matchers_agree_with_each_other_and_jax(seed):
    a, num_c = _match_inputs(seed)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j_rank = JM.compute_class_ranks(j["dl"], j["dv"], num_c)
    t_rank = PM.compute_class_ranks(t["dl"], t["dv"], num_c)
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(j_rank))
    j_args = (j["iou"], j["dl"], j["dv"] & (j_rank < 10), j["dia"], j["gl"], j["gv"], j["gc"], j["gig"], j["thr"])
    t_args = (t["iou"], t["dl"], t["dv"] & (t_rank < 10), t["dia"], t["gl"], t["gv"], t["gc"], t["gig"], t["thr"])
    max_rank = int((torch.where(t_args[2], t_rank, -1)).max()) + 1
    want = JM.match_detections(*j_args)
    slot = PM.match_detections(*t_args)
    ranked = PM.match_detections_ranked(*t_args, t_rank, num_c, max_rank)
    for got in (slot, ranked):
        np.testing.assert_array_equal(got.matched.numpy(), np.asarray(want.matched))
        np.testing.assert_array_equal(got.ignored.numpy(), np.asarray(want.ignored))
    want_ranked = JM.match_detections_ranked(*j_args, j_rank, num_c, max_rank)
    np.testing.assert_array_equal(ranked.matched.numpy(), np.asarray(want_ranked.matched))


@pytest.mark.parametrize(("max_class_rank", "num_classes"), [(0, 3), (16, 1)])
def test_evaluate_map_matches_jax(max_class_rank, num_classes):
    rng = np.random.default_rng(max_class_rank)
    num_i, num_d, num_g = 5, 16, 8

    def boxes(*shape):
        xy = rng.random((*shape, 2)) * 100
        return np.concatenate([xy, xy + np.exp(rng.random((*shape, 2)) * 4) + 1], -1).astype(np.float32)

    gt_boxes = boxes(num_i, num_g)
    det_boxes = np.where(rng.random((num_i, num_d, 1)) < 0.6,
                         gt_boxes[:, rng.integers(0, num_g, num_d)] + rng.normal(0, 3, (num_i, num_d, 4)),
                         boxes(num_i, num_d)).astype(np.float32)
    area = lambda b: ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).astype(np.float32)  # noqa: E731
    arrays = [
        det_boxes, np.round(rng.random((num_i, num_d)), 2).astype(np.float32),
        rng.integers(0, num_classes, (num_i, num_d)).astype(np.int32), rng.random((num_i, num_d)) < 0.85,
        area(det_boxes), gt_boxes, rng.integers(0, num_classes, (num_i, num_g)).astype(np.int32),
        rng.random((num_i, num_g)) < 0.8, rng.random((num_i, num_g)) < 0.15, area(gt_boxes),
        np.array([*range(num_classes), -1, -1, -1, -1][:4], np.int32), np.asarray(IOU_THRS, np.float32),
        np.asarray(REC_THRS, np.float32),
    ]
    kw = dict(max_dets=(1, 10, 100), num_classes=num_classes, max_class_rank=max_class_rank)
    want = JM.evaluate_map(*[jnp.asarray(x) for x in arrays], max_class_dets=64, **kw)
    got = PM.evaluate_map(*[torch.from_numpy(x) for x in arrays], **kw)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_coco_round_trip_matches_jax_files(tmp_path):
    preds, targets = _mask_dataset(9)
    for d in (*preds, *targets):
        n = d["masks"].shape[0]
        d["boxes"] = np.tile(np.array([[1.0, 2.0, 20.5, 18.0]], np.float32), (n, 1)) + np.arange(n)[:, None]
    keys = (BOX_KEYS[0] | {"masks"}, BOX_KEYS[1] | {"masks"})
    jm, pm = JaxMAP(iou_type=("bbox", "segm")), MeanAveragePrecision(iou_type=("bbox", "segm"), device="cpu")
    jm.update(_jnp(preds, keys[0]), _jnp(targets, keys[1]))
    pm.update(_torch(preds, keys[0]), _torch(targets, keys[1]))
    jm.tm_to_coco(str(tmp_path / "jax"))
    pm.tm_to_coco(str(tmp_path / "port"))
    for side in ("preds", "target"):
        assert (tmp_path / f"port_{side}.json").read_text() == (tmp_path / f"jax_{side}.json").read_text()
    p2, t2 = MeanAveragePrecision.coco_to_tm(str(tmp_path / "port_preds.json"), str(tmp_path / "port_target.json"),
                                             iou_type=("bbox", "segm"))
    for got, want in zip((*p2, *t2), (*preds, *targets)):
        np.testing.assert_array_equal(got["masks"].numpy().astype(bool), want["masks"])
    again = MeanAveragePrecision(iou_type=("bbox", "segm"), box_format="xywh", device="cpu")
    again.update(p2, t2)
    _assert_same({k: v.numpy() for k, v in pm.compute().items()}, {k: v.numpy() for k, v in again.compute().items()})


def test_host_backends_and_bad_arguments_raise_like_jax():
    metric = MeanAveragePrecision(device="cpu")
    with pytest.raises(ModuleNotFoundError):
        _ = metric.coco
    for kw in (dict(box_format="xyxyx"), dict(iou_type="keypoints"), dict(iou_thresholds=0.5),
               dict(average="weighted"), dict(class_metrics=1)):
        with pytest.raises(ValueError):
            JaxMAP(**kw)
        with pytest.raises(ValueError):
            MeanAveragePrecision(device="cpu", **kw)
    with pytest.raises(ValueError, match="same length"):
        metric.update([], [dict(boxes=np.zeros((0, 4)), labels=np.zeros(0))])
    with pytest.raises(ValueError, match="scores"):
        metric.update([dict(boxes=np.zeros((0, 4)), labels=np.zeros(0))], [dict(boxes=np.zeros((0, 4)), labels=np.zeros(0))])
    with pytest.warns(UserWarning, match="more than 2 detections"):
        MeanAveragePrecision(max_detection_thresholds=[1, 2], device="cpu").update(
            [dict(boxes=np.ones((3, 4)), scores=np.ones(3), labels=np.zeros(3, int))],
            [dict(boxes=np.ones((1, 4)), labels=np.zeros(1, int))])


def test_exports_match_the_jax_package():
    import torchmetrics_tpu as jax_pkg
    import torchmetrics_tpu_torch as port

    for module in ("detection", "functional.detection"):
        want = sorted(__import__(f"torchmetrics_tpu.{module}", fromlist=["__all__"]).__all__)
        got = sorted(__import__(f"torchmetrics_tpu_torch.{module}", fromlist=["__all__"]).__all__)
        assert got == want, module
    assert all(hasattr(port, name) for name in jax_pkg.detection.__all__)
    assert all(hasattr(port.functional, name) for name in jax_pkg.functional.detection.__all__)
