"""Snapshot and restore of the SPMD engine's rows through boundary host copies.

From ``tests/unittests/spmd/test_snapshot.py``, on a mesh of 8 rows on the
CPU: a ``SnapshotManager`` attached to the engine snapshots the rows at its
boundaries (``note_update``), a fresh engine restores them, and streams on.
Restored values must equal the live stream's (``RTOL``, the same float32
sums in the same order, so in practice equal).
"""

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as TM
from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy
from torchmetrics_tpu_torch._spmd import build_mesh, faultinject
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

WORLD = 8
B = 8 * WORLD
C = 4
RTOL = 1e-6
MESH = build_mesh(devices=["cpu"] * WORLD)
RNG = np.random.default_rng(33)


def _batches(n):
    return [
        (torch.from_numpy(RNG.random((B, C)).astype(np.float32)), torch.from_numpy(RNG.integers(0, C, B)))
        for _ in range(n)
    ]


def _engine(mesh=MESH):
    return TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=mesh)


def test_restore_returns_to_newest_boundary(tmp_path):
    eng = _engine()
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=2, async_write=False))
    vals = [float(eng.step(p, t)) for p, t in _batches(4)]
    mgr.close()
    # boundaries: the base snapshot after step 1, a periodic one after step 3;
    # step 4 falls between boundaries and is the (documented) loss window
    fresh = _engine()
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    report = mgr2.restore_latest()
    assert report.replayed == 0  # opaque in-graph steps are not arg-journaled
    assert fresh.steps == 3
    assert abs(float(fresh.compute()) - vals[2]) < RTOL
    mgr2.close()


def test_restored_engine_keeps_streaming_fused(tmp_path):
    eng = _engine()
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=1, async_write=False))
    batches = _batches(3)
    for p, t in batches[:2]:
        live = eng.step(p, t)
    mgr.close()
    fresh = _engine()
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    mgr2.restore_latest()
    np.testing.assert_allclose(float(fresh.compute()), float(live), rtol=RTOL)
    v_fresh = fresh.step(*batches[2])
    v_live = eng.step(*batches[2])
    assert not fresh.degraded
    np.testing.assert_allclose(float(v_fresh), float(v_live), rtol=RTOL)
    mgr2.close()


def test_snapshot_counts_and_integrity_block(tmp_path):
    eng = _engine()
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=2, async_write=False))
    for p, t in _batches(4):
        eng.step(p, t)
    assert mgr.snapshots_taken == 2
    sd = eng.state_dict(integrity=True)
    assert "#integrity" in sd and "#spmd" in sd
    assert sd["#spmd"]["world"] == WORLD
    for key, val in sd.items():
        if not key.startswith("#"):
            assert val.shape[0] == WORLD  # stacked per-row states
    mgr.close()


def test_collection_snapshot_roundtrip(tmp_path):
    def make():
        return TM.MetricCollection(
            [TM.MulticlassAccuracy(num_classes=C, device="cpu"), TM.MulticlassPrecision(num_classes=C, device="cpu")]
        )

    eng = make().to_spmd(mesh=MESH)
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=1, async_write=False))
    for p, t in _batches(2):
        live = eng.step(p, t)
    mgr.close()
    fresh = make().to_spmd(mesh=MESH)
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    mgr2.restore_latest()
    restored = fresh.compute()
    for key in live:
        np.testing.assert_allclose(np.asarray(restored[key]), np.asarray(live[key]), rtol=RTOL, err_msg=key)
    mgr2.close()


def test_mesh_mismatch_rejected():
    eng = _engine()
    for p, t in _batches(1):
        eng.step(p, t)
    sd = eng.state_dict(integrity=True)
    small = _engine(build_mesh("dp", ["cpu"]))
    with pytest.raises(TorchMetricsUserError, match="identical mesh layout"):
        small.load_state_dict(sd)


def test_reset_after_restore_returns_to_defaults(tmp_path):
    """A restore before the first step must leave reset() working: the rows go back to the DEFAULTS."""
    eng = _engine()
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=1, async_write=False))
    batches = _batches(3)
    for p, t in batches[:2]:
        eng.step(p, t)
    mgr.close()
    fresh = _engine()
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    mgr2.restore_latest()
    mgr2.close()
    fresh.reset()
    assert fresh.steps == 0
    brand_new = _engine()
    np.testing.assert_allclose(float(fresh.step(*batches[2])), float(brand_new.step(*batches[2])), rtol=RTOL)


def test_degradation_takes_final_boundary_snapshot_and_pauses(tmp_path):
    """A degrade mid-stream captures one final boundary (the folded state) and pauses the manager, and says so."""
    m = TM.MulticlassAccuracy(num_classes=C, device="cpu")
    eng = m.to_spmd(mesh=MESH)
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=10, async_write=False))
    batches = _batches(3)
    for p, t in batches[:2]:
        pre_degrade = eng.step(p, t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faultinject.inject_step_failure():
            eng.step(*batches[2])
    assert eng.degraded and mgr._paused
    assert any("PAUSED" in e.detail for e in m.resilience_report().events)
    mgr.close()
    # the final boundary snapshot holds the state as of the LAST fused step
    fresh = _engine()
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    mgr2.restore_latest()
    np.testing.assert_allclose(float(fresh.compute()), float(pre_degrade), rtol=RTOL)
    mgr2.close()


def test_state_dict_before_first_step_raises():
    with pytest.raises(TorchMetricsUserError, match="no device states"):
        _engine().state_dict()


class RingMean(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(cat_state_capacity=32, device="cpu")
        self.add_state("vals", default=[], dist_reduce_fx="cat")

    def update(self, x):
        self.vals.append(x)

    def compute(self):
        data, valid = self.vals.masked()
        return torch.where(valid, data, 0.0).sum() / valid.sum()


def test_ring_rows_restore_before_the_first_step(tmp_path):
    """A ring state's rows restore into an engine that has seen no batch, stream on, and reset to zeroed rings."""
    eng = RingMean().to_spmd(mesh=MESH, enforce_manifest=False)
    mgr = SnapshotManager(eng, tmp_path, SnapshotPolicy(every_n_updates=1, async_write=False))
    xs = [torch.from_numpy(RNG.random(B).astype(np.float32)) for _ in range(3)]
    for x in xs[:2]:
        eng.step(x)
    mgr.close()
    fresh = RingMean().to_spmd(mesh=MESH, enforce_manifest=False)
    mgr2 = SnapshotManager(fresh, tmp_path, SnapshotPolicy(async_write=False))
    mgr2.restore_latest()
    mgr2.close()
    assert fresh._states[""]["vals"]["data"].shape == (WORLD, 32)
    np.testing.assert_allclose(float(fresh.step(xs[2])), float(eng.step(xs[2])), rtol=RTOL)
    np.testing.assert_allclose(float(eng.compute()), float(torch.cat(xs).mean()), rtol=1e-5)
    fresh.reset()
    assert int(fresh._states[""]["vals"]["count"].sum()) == 0 and not bool(fresh._states[""]["vals"]["valid"].any())
