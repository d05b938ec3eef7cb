"""The port's ``FleetTree`` (``tests/unittests/fleet/test_tree.py``).

Tree topology, epoch driving and hierarchy golden equality. Where the JAX
test builds a tree, the same rows go through both packages' trees (the
port's metrics on ``device="cpu"``): the roots must agree at rtol 1e-5, and
every node's ``Rollup`` must name the same contributing, missing and
source sets with the same counts. Added for the port: the canonical
``(8, 8)`` tree of 300-class confusion matrices (B1's class range on the
card) is bit for bit a numpy ``bincount`` at the root and at every region.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_fleet_node import receipt
from tests.test_torch_fleet_transport import JAX, PORT, SIDES, value
from torchmetrics_tpu.collections import MetricCollection as JCollection
from torchmetrics_tpu.regression import MeanSquaredError as JMSE
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
from torchmetrics_tpu_torch.collections import MetricCollection as TCollection
from torchmetrics_tpu_torch.regression import MeanSquaredError as TMSE

RTOL = 1e-5


def _retry(S):
    return S.Retry(max_retries=2, backoff_base=0.005, backoff_max=0.02)


def _receipts(tree):
    return {nid: receipt(n.last_rollup) for nid, n in tree.nodes.items() if n.last_rollup is not None}


class TestBuild:
    def test_three_level_shape_and_regions(self):
        shapes = {}
        for S in SIDES:
            tree = S.fleet.FleetTree.build(S.agg.MeanMetric(**S.kw), (2, 3), retry=_retry(S))
            assert [len(level) for level in tree.levels] == [1, 2, 6]
            assert tree.root.node_id == "global"
            assert {n.node_id for n in tree.levels[1]} == {"region-00", "region-01"}
            # every edge carries its level-1 ancestor as its region label
            for leaf in tree.leaves:
                assert leaf.region in ("region-00", "region-01")
                assert leaf.node_id.startswith("edge-")
            assert tree.nodes["region-00"].children == ("edge-00-00", "edge-00-01", "edge-00-02")
            shapes[S.name] = [[(n.node_id, n.region, n.children) for n in level] for level in tree.levels]
        assert shapes["port"] == shapes["jax"]

    def test_four_level_tree_builds(self):
        ids = {}
        for S in SIDES:
            tree = S.fleet.FleetTree.build(S.agg.MeanMetric(**S.kw), (2, 2, 2), retry=_retry(S))
            assert [len(level) for level in tree.levels] == [1, 2, 4, 8]
            assert all(n.node_id.startswith("zone-") for n in tree.levels[2])
            assert all(n.node_id.startswith("edge-") for n in tree.levels[3])
            ids[S.name] = sorted(tree.nodes)
        assert ids["port"] == ids["jax"]

    def test_invalid_branching_rejected(self):
        for bad in ((), (2, 0)):
            with pytest.raises(ValueError):
                PORT.fleet.FleetTree.build(PORT.agg.MeanMetric(**PORT.kw), bad)
            with pytest.raises(ValueError):
                JAX.fleet.FleetTree.build(JAX.agg.MeanMetric(), bad)


class TestRunEpoch:
    def test_hierarchy_equals_flat_fold(self):
        rng = np.random.default_rng(11)
        rows = [[[float(rng.uniform()) for _ in range(3)] for _ in range(4)] for _ in range(4)]
        out = {}
        for S in SIDES:
            tree = S.fleet.FleetTree.build(S.agg.MeanMetric(**S.kw), (2, 2), deadline_s=1.0, retry=_retry(S))
            golden = S.agg.MeanMetric(**S.kw)
            receipts = []
            for epoch in range(4):
                for leaf, vals in zip(tree.leaves, rows[epoch]):
                    for v in vals:
                        leaf.update(v)
                        golden.update(v)
                rollup = tree.run_epoch(epoch)
                assert not rollup.partial
                receipts.append(_receipts(tree))
            tree.join_pending(timeout=5.0)
            assert len(tree.root.folded_sources) == 4 * 4
            np.testing.assert_allclose(value(tree.root.metric.compute()), value(golden.compute()), rtol=RTOL)
            out[S.name] = (receipts, value(tree.root.metric.compute()), tree.root.folded_sources)
        assert out["port"][0] == out["jax"][0]
        np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=RTOL)
        assert out["port"][2] == out["jax"][2]

    def test_skip_degrades_only_that_region(self):
        out = {}
        for S in SIDES:
            tree = S.fleet.FleetTree.build(S.agg.MeanMetric(**S.kw), (2, 2), deadline_s=0.05, retry=_retry(S))
            for leaf in tree.leaves:
                leaf.update(1.0)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rollup = tree.run_epoch(0, skip=("edge-00-00",))
            tree.join_pending(timeout=5.0)
            assert not rollup.partial  # the root still hears from both regions
            region = tree.nodes["region-00"].last_rollup
            assert region.partial and region.missing == ("edge-00-00",)
            assert not tree.nodes["region-01"].last_rollup.partial
            out[S.name] = (_receipts(tree), value(tree.root.metric.compute()))
        assert out["port"][0] == out["jax"][0]
        np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=RTOL)

    def test_metric_collection_merges_member_wise(self):
        # the collection-level fold seam the fleet tier leans on
        rng = np.random.default_rng(3)
        batches = [(rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)) for _ in range(6)]
        results = {}
        for name, Coll, Mean, MSE, arr in (
            ("jax", JCollection, JAX.agg.MeanMetric, JMSE, np.asarray),
            ("port", TCollection, lambda: PORT.agg.MeanMetric(device="cpu"), lambda: TMSE(device="cpu"),
             torch.as_tensor),
        ):
            golden = Coll({"mean": Mean(), "mse": MSE()})
            a = Coll({"mean": Mean(), "mse": MSE()})
            b = Coll({"mean": Mean(), "mse": MSE()})
            for i, (p, t) in enumerate(batches):
                (a if i < 4 else b).update(arr(p), arr(t))
                golden.update(arr(p), arr(t))
            a.merge_state(b)
            got, want = a.compute(), golden.compute()
            for key, val in got.items():
                np.testing.assert_allclose(value(val), value(want[key]), rtol=RTOL)
            results[name] = {k: value(v) for k, v in got.items()}
        for key in results["jax"]:
            np.testing.assert_allclose(results["port"][key], results["jax"][key], rtol=RTOL)


def test_canonical_tree_of_confusion_matrices_is_bit_for_bit():
    """``branching=(8, 8)``: 64 edges of a 300-class matrix, two epochs, every level against numpy."""
    c, n = 300, 64
    template = MulticlassConfusionMatrix(num_classes=c, device="cpu")
    tree = PORT.fleet.FleetTree.build(template, (8, 8), retry=_retry(PORT))
    rng = np.random.default_rng(23)
    fed = {leaf.node_id: [] for leaf in tree.leaves}
    for epoch in range(2):
        for leaf in tree.leaves:
            p, t = rng.integers(0, c, n), rng.integers(0, c, n)
            leaf.update(torch.as_tensor(p), torch.as_tensor(t))
            fed[leaf.node_id].append(t * c + p)
        rollup = tree.run_epoch(epoch)
        assert not rollup.partial and len(rollup.contributing) == 8
    tree.join_pending(timeout=5.0)
    assert len(tree.root.folded_sources) == 128
    assert not [t for t in threading.enumerate() if t.name.startswith("fleet-publish-")]

    def counts(leaf_ids):
        flat = np.concatenate([x for lid in leaf_ids for x in fed[lid]])
        return np.bincount(flat, minlength=c * c).reshape(c, c)

    np.testing.assert_array_equal(tree.root.metric.confmat.numpy(), counts(fed))
    for region in tree.levels[1]:
        np.testing.assert_array_equal(region.metric.confmat.numpy(), counts(region.children))

