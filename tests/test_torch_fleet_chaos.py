"""The port's fleet chaos soak (``tests/unittests/fleet/test_chaos.py``).

One ``run_fleet_chaos`` run of each package on the JAX suite's spec and
rows (``MeanMetric``, the port's on ``device="cpu"``) composes every
failure mode the fleet tier claims to survive; the port's receipt must
hold the JAX test's invariants, and the same fault ledger and root as the
JAX package's: the same fed, folded and lost sources, degradation events
by kind, quarantines, drops and late folds, and the root's value at rtol
1e-5. The JAX suite runs one schedule under its lock sanitizer; the port
has none (no ``_analysis/`` yet), and its counterpart asserts instead that
no ``fleet-publish-*`` thread is alive after the run's ``join_pending`` and
that the root equals the JAX package's golden fold.
"""

import threading

import numpy as np
import pytest

import torchmetrics_tpu._fleet.chaos as j_chaos
import torchmetrics_tpu_torch._fleet.chaos as t_chaos
from tests.test_torch_fleet_transport import JAX, PORT, value
from torchmetrics_tpu_torch._fleet import FleetChaosSpec, run_fleet_chaos

RTOL, ATOL = 1e-5, 1e-6


def _make_update(rng):
    return (float(rng.uniform()),)


SPEC = FleetChaosSpec(epochs=10, branching=(2, 3), rows_per_epoch=2, deadline_s=0.25)


def _run(S, chaos, spec):
    """One package's chaos run on ``spec``, with the tree it built."""
    trees = []
    build = chaos.FleetTree.build

    def recorded(*args, **kwargs):
        tree = build(*args, **kwargs)
        trees.append(tree)
        return tree

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chaos.FleetTree, "build", recorded)
        with pytest.warns(UserWarning):
            result = chaos.run_fleet_chaos(S.agg.MeanMetric(**S.kw), _make_update,
                                           chaos.FleetChaosSpec(**vars(spec)) if S is JAX else spec)
    return result, trees[0]


@pytest.fixture(scope="module")
def soak():
    # one soak a package, many assertions: the run composes every fault and
    # takes a few seconds of wall clock
    return _run(PORT, t_chaos, SPEC), _run(JAX, j_chaos, SPEC)


def _ledger(result, tree):
    return dict(
        epochs_run=result.epochs_run, leaves=result.leaves, rows_fed=result.rows_fed,
        partial=result.partial_rollups, dup=result.duplicates_dropped, corrupt=result.corrupt_quarantined,
        late=result.late_folds, transient=result.transient_recovered, degraded=result.publish_degraded,
        reaped=result.ttl_reaped, golden_checks=result.golden_checks, lost=result.lost_sources,
        events=result.events_by_kind, dumps=result.dumps_by_kind, fault_events=result.fault_events,
        folded=tree.root.folded_sources,
    )


class TestFleetChaos:
    def test_soak_is_ok(self, soak):
        (res, _), _ = soak
        assert res.ok, res.describe()
        assert res.failures == []
        assert res.epochs_run == SPEC.epochs + SPEC.drain_epochs
        assert res.leaves == 6

    def test_golden_equality_every_fenced_epoch(self, soak):
        (res, tree), (jres, jtree) = soak
        assert res.golden_checks == SPEC.epochs + SPEC.drain_epochs
        assert res.golden_equal
        np.testing.assert_allclose(value(tree.root.metric.compute()), value(jtree.root.metric.compute()),
                                   rtol=RTOL, atol=ATOL)

    def test_every_fault_fired_and_was_survived(self, soak):
        (res, tree), (jres, jtree) = soak
        assert res.partial_rollups >= 3  # kill, publish-fail, straggler epochs
        assert res.corrupt_quarantined == 1
        assert res.duplicates_dropped >= 1  # recent zombie fenced by the ledger
        assert res.transient_recovered == 1  # one fault absorbed by retry
        assert res.publish_degraded == 1  # retries exhausted -> delta retained
        assert res.late_folds >= 1  # straggler folded next epoch, not lost
        assert res.ttl_reaped >= 1  # stale zombie reaped by the janitor
        assert _ledger(res, tree) == _ledger(jres, jtree)

    def test_exactly_once_no_lost_live_sources(self, soak):
        # every (leaf, epoch) fed to a live leaf is folded exactly once,
        # minus only the contributions destroyed by injected corruption
        (res, tree), _ = soak
        assert res.lost_sources  # corruption did destroy something real
        assert res.rows_fed > 0
        assert not tree.root.folded_sources & res.lost_sources

    def test_staleness_stays_within_budget(self, soak):
        (res, _), _ = soak
        assert 0.0 <= res.max_staleness_ms <= SPEC.staleness_budget_ms
        assert res.within_budget

    def test_each_degradation_kind_dumped_once_per_event(self, soak):
        (res, _), (jres, _) = soak
        assert res.dumps_match_events, (res.events_by_kind, res.dumps_by_kind)
        for kind in ("fleet_partial", "fleet_corrupt", "fleet_publish_degraded"):
            assert res.events_by_kind.get(kind, 0) >= 1, kind
        assert res.events_by_kind == jres.events_by_kind

    def test_describe_is_one_line_receipt(self, soak):
        (res, _), _ = soak
        line = res.describe()
        assert line.startswith("fleet-chaos[OK]") and "\n" not in line
        assert "golden=equal" in line


def test_chaos_leaves_no_publisher_thread_and_folds_golden():
    """The JAX suite's lock-sanitizer run, without a sanitizer: no send thread outlives the run, and the
    folds equal the JAX package's golden ones."""
    spec = FleetChaosSpec(branching=(2, 2), rows_per_epoch=1, deadline_s=0.25)
    res, tree = _run(PORT, t_chaos, spec)
    assert res.ok, res.describe()
    assert not [t for t in threading.enumerate() if t.name.startswith("fleet-publish-") and t.is_alive()]
    jres, jtree = _run(JAX, j_chaos, spec)
    assert jres.ok, jres.describe()
    assert tree.root.folded_sources == jtree.root.folded_sources
    np.testing.assert_allclose(value(tree.root.metric.compute()), value(jtree.root.metric.compute()),
                               rtol=RTOL, atol=ATOL)


def test_chaos_under_locksan_is_clean():
    """The fleet tier's lock discipline (publish lock, the KV's condition, the region labeler), sanitized under load."""
    from torchmetrics_tpu_torch._analysis import locksan

    spec = FleetChaosSpec(branching=(2, 2), rows_per_epoch=1, deadline_s=0.25)
    locksan.set_locksan_enabled(True)
    locksan.reset()
    try:
        with pytest.warns(UserWarning):
            res = run_fleet_chaos(PORT.agg.MeanMetric(device="cpu"), _make_update, spec)
        assert res.ok, res.describe()
        assert locksan.violations() == []
    finally:
        locksan.set_locksan_enabled(False)
        locksan.reset()


def test_flight_dumps_land_on_disk(tmp_path):
    spec = FleetChaosSpec(branching=(2, 2), rows_per_epoch=1, deadline_s=0.25, flight_dir=str(tmp_path))
    with pytest.warns(UserWarning):
        res = run_fleet_chaos(PORT.agg.MeanMetric(device="cpu"), _make_update, spec)
    assert res.ok, res.describe()
    dumps = sorted(tmp_path.glob("*.json"))
    assert len(dumps) >= 1  # degradations persisted for post-mortem
    assert len(dumps) >= sum(res.dumps_by_kind.values())


def test_spec_validation():
    with pytest.raises(ValueError):
        FleetChaosSpec(epochs=0)
    with pytest.raises(ValueError):
        FleetChaosSpec(branching=())
    with pytest.raises(ValueError):
        FleetChaosSpec(zombie_capture_epoch=9, zombie_epoch=8)
    with pytest.raises(ValueError):
        FleetChaosSpec(deadline_s=0.0)
    assert FleetChaosSpec(deadline_s=0.5).effective_stall_s == 2.0
