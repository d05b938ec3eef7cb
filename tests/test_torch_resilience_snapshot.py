"""The port's SnapshotManager against the JAX package's, on the CPU.

From ``tests/unittests/resilience/test_snapshot.py``: atomic rotation,
fallback past corruption, the journal and its replay, each scenario run
through both packages on the same seeded numpy batches. Writer threads are
closed and joined in every test. Added for the port: snapshot directories
written by one package restore into the other (the on-disk format is
shared), and a journal replayed through the compiled update matches an
uninterrupted compiled stream bit for bit.
"""

import os
import pickle
import shutil
import threading
import time
from copy import deepcopy

import numpy as np
import pytest
import torch

from tests.test_torch_resilience_integrity import JAX, PORT, both, close, host

SYNC = dict(async_write=False)


def _batches(S, n, size=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(S.arr(rng.normal(size=size).astype(np.float32)), S.arr(rng.normal(size=size).astype(np.float32)))
            for _ in range(n)]


def _snaps(d):
    return sorted(f for f in os.listdir(d) if f.startswith("snap-"))


def _journals(d):
    return sorted(f for f in os.listdir(d) if f.startswith("journal-"))


def _gen(name):
    return int(name.split("-")[1].split(".")[0])


def _mse(S, **kw):
    return S.tm.MeanSquaredError(**S.kw, **kw)


def _mae(S, **kw):
    return S.tm.MeanAbsoluteError(**S.kw, **kw)


def _policy(S, **kw):
    return S.res.SnapshotPolicy(**kw)


@pytest.fixture()
def dirs(tmp_path):
    """One directory a package."""
    return {JAX.name: tmp_path / "jax", PORT.name: tmp_path / "port"}


def test_atomic_rotation_keeps_last_k(dirs):
    def run(S):
        d = dirs[S.name]
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, d, _policy(S, every_n_updates=1, keep=2, **SYNC))
        for p, t in _batches(S, 7):
            m.update(p, t)
        mgr.close()
        snaps = _snaps(d)
        assert [_gen(s) for s in snaps] == [mgr.generation - 1, mgr.generation]
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
        assert min(_gen(j) for j in _journals(d)) >= _gen(snaps[0])
        return snaps, _journals(d)

    j, p = both(run)
    assert j == p


def test_restore_roundtrip_into_fresh_instance(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=3, **SYNC))
        for p, t in _batches(S, 8):
            m.update(p, t)
        mgr.close()
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            report = mgr2.restore_latest()
        assert fresh._update_count == m._update_count
        close(fresh.compute(), m.compute())
        return report.generation, report.replayed, report.fell_back, float(host(fresh.compute()))

    (jg, jr, jf, jv), (pg, pr, pf, pv) = both(run)
    assert (jg, jr, jf) == (pg, pr, pf) and not pf
    assert jv == pytest.approx(pv, rel=1e-6)


def test_corrupt_newest_generation_falls_back(dirs):
    def run(S):
        d = dirs[S.name]
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, d, _policy(S, every_n_updates=2, **SYNC))
        for p, t in _batches(S, 7):
            m.update(p, t)
        mgr.close()
        S.fi.corrupt_file(d / _snaps(d)[-1], "bitflip", seed=1)
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, d, _policy(S, **SYNC)) as mgr2, pytest.warns(UserWarning):
            report = mgr2.restore_latest()
        close(fresh.compute(), m.compute())
        assert any(e.kind == "snapshot_restore" for e in fresh.resilience_report().events)
        return sorted(report.skipped), report.generation, report.replayed

    j, p = both(run)
    assert j == p and p[0]


def test_every_generation_corrupt_raises(dirs):
    def run(S):
        d = dirs[S.name]
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, d, _policy(S, every_n_updates=2, **SYNC))
        for p, t in _batches(S, 5):
            m.update(p, t)
        mgr.close()
        for s in _snaps(d):
            S.fi.corrupt_file(d / s, "bitflip", seed=2)
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, d, _policy(S, **SYNC)) as mgr2:
            with pytest.raises(S.res.SnapshotRestoreError) as err:
                mgr2.restore_latest()
        return sorted(err.value.failures)

    j, p = both(run)
    assert j == p and p


def test_journal_bound_forces_rotation(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=None, every_seconds=None,
                                                            journal_max_entries=3, **SYNC))
        for p, t in _batches(S, 10):
            m.update(p, t)
        out = (mgr.journal_len, mgr.snapshots_taken)
        mgr.close()
        return out

    j, p = both(run)
    assert j == p and p[0] < 3 and p[1] >= 3


def test_truncated_journal_replays_clean_prefix(dirs):
    def run(S):
        d = dirs[S.name]
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, d, _policy(S, every_n_updates=100, **SYNC))
        batches = _batches(S, 5)
        for p, t in batches:
            m.update(p, t)
        mgr.close()
        journal = d / _journals(d)[-1]
        raw = journal.read_bytes()
        journal.write_bytes(raw[: len(raw) - 7])  # a crash mid-append
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, d, _policy(S, **SYNC)) as mgr2, pytest.warns(UserWarning):
            report = mgr2.restore_latest()
        golden = _mse(S)
        for p, t in batches[:4]:
            golden.update(p, t)
        close(fresh.compute(), golden.compute())
        return report.truncated_journal, report.replayed

    assert both(run) == ((True, 3), (True, 3))


def test_restore_is_idempotent(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=2, **SYNC))
        for p, t in _batches(S, 6):
            m.update(p, t)
        mgr.simulate_preemption()
        states = []
        for _ in range(3):
            fresh = _mse(S)
            with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
                mgr2.restore_latest()
            states.append({k: host(v) for k, v in fresh.state_dict(all_states=True).items()})
        for later in states[1:]:
            for key in states[0]:
                np.testing.assert_array_equal(states[0][key], later[key])
        return states[0]

    j, p = both(run)
    for key in p:
        close(j[key], p[key])


def test_async_preemption_with_dropped_writes_restores_everything(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=3, async_write=True))
        batches = _batches(S, 8)
        for p, t in batches:
            m.update(p, t)
        mgr.simulate_preemption()  # pending async writes die with the "process"
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            mgr2.restore_latest()
        golden = _mse(S)
        for p, t in batches:
            golden.update(p, t)
        close(fresh.compute(), golden.compute())
        return float(host(fresh.compute()))

    j, p = both(run)
    assert j == pytest.approx(p, rel=1e-6)


def test_forward_journals_once_per_batch(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=100, **SYNC))
        for p, t in _batches(S, 4):
            m(p, t)  # forward's stash/reset dance journals exactly once
        journaled = mgr.journaled_updates
        mgr.close()
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            mgr2.restore_latest()
        close(fresh.compute(), m.compute())
        return journaled, fresh._update_count

    assert both(run) == ((3, 4), (3, 4))


def test_quarantined_batch_replays_to_same_state(dirs):
    def run(S):
        m = _mse(S, nan_policy="quarantine")
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=100, **SYNC))
        with pytest.warns(UserWarning):
            for i, (p, t) in enumerate(_batches(S, 4)):
                m.update(S.fi.poison_nans(p) if i == 2 else p, t)
        mgr.close()
        fresh = _mse(S, nan_policy="quarantine")
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2, pytest.warns(UserWarning):
            mgr2.restore_latest()  # the poisoned entry is quarantined again on replay
        close(fresh.compute(), m.compute())
        return fresh._update_count, m._update_count

    assert both(run) == ((3, 3), (3, 3))


def test_scan_update_entries_replay_through_scan(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=100, **SYNC))
        rng = np.random.default_rng(3)
        stream = S.arr(rng.normal(size=(5, 8)).astype(np.float32))
        target = S.arr(rng.normal(size=(5, 8)).astype(np.float32))
        m.update(stream[0], target[0])  # the base snapshot's anchor
        m.scan_update(stream[1:], target[1:])
        mgr.close()
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            report = mgr2.restore_latest()
        close(fresh.compute(), m.compute(), rtol=1e-6)
        return m._update_count, fresh._update_count, report.replayed

    assert both(run) == ((5, 5, 1), (5, 5, 1))


def _pair(S):
    return S.tm.MetricCollection([_mse(S), _mae(S)])


def test_collection_roundtrip_and_counts(dirs):
    def run(S):
        col = _pair(S)
        mgr = S.res.SnapshotManager(col, dirs[S.name], _policy(S, every_n_updates=2, **SYNC))
        for p, t in _batches(S, 5):
            col.update(p, t)
        mgr.close()
        fresh = _pair(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            mgr2.restore_latest()
        a, b = col.compute(), fresh.compute()
        assert set(a) == set(b)
        for k in a:
            close(a[k], b[k])
        return {name: (m._update_count, col._modules[name]._update_count) for name, m in fresh._modules.items()}

    j, p = both(run)
    assert j == p == {"MeanSquaredError": (5, 5), "MeanAbsoluteError": (5, 5)}


def test_io_failure_degrades_without_breaking_updates(dirs):
    def run(S):
        d = dirs[S.name] / "snaps"
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, d, _policy(S, every_n_updates=1, **SYNC))
        batches = _batches(S, 4)
        m.update(*batches[0])
        shutil.rmtree(d)  # the durability volume goes away under the manager
        with pytest.warns(UserWarning, match="snapshot_degraded|degraded"):
            m.update(*batches[1])
        m.update(*batches[2])  # the stream keeps flowing
        golden = _mse(S)
        for p, t in batches[:3]:
            golden.update(p, t)
        close(m.compute(), golden.compute())
        out = (mgr.last_error is not None, [e.kind for e in m.resilience_report().events])
        mgr.close()
        return out

    assert both(run) == ((True, ["snapshot_degraded"]), (True, ["snapshot_degraded"]))


def test_second_manager_on_same_target_rejected(dirs):
    for S in (JAX, PORT):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name] / "a", _policy(S, **SYNC))
        with pytest.raises(ValueError, match="already has an active SnapshotManager"):
            S.res.SnapshotManager(m, dirs[S.name] / "b", _policy(S, **SYNC))
        mgr.close()
        S.res.SnapshotManager(m, dirs[S.name] / "b", _policy(S, **SYNC)).close()  # after close, a replacement is legal


def test_clone_and_pickle_travel_without_the_hook(dirs):
    for S in (JAX, PORT):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, **SYNC))
        for p, t in _batches(S, 2):
            m.update(p, t)
        clone = deepcopy(m)
        assert clone.__dict__.get("_snapshot_hook") is None
        revived = pickle.loads(pickle.dumps(m))
        assert revived.__dict__.get("_snapshot_hook") is None
        close(revived.compute(), m.compute())
        assert m.__dict__["_snapshot_hook"] is mgr
        mgr.close()


def test_state_dict_all_states_covers_non_persistent():
    def run(S):
        m = S.tm.aggregation.SumMetric(**S.kw)
        m.update(S.arr(np.float32(3.0)))
        assert not any(m._persistent.values()) and m.state_dict() == {}
        full = m.state_dict(all_states=True, integrity=True)
        assert "value" in full and "#integrity" in full
        fresh = S.tm.aggregation.SumMetric(**S.kw)
        fresh.load_state_dict(full, strict=True)
        return float(host(fresh.compute())), full["#integrity"]

    (jv, jb), (pv, pb) = both(run)
    assert jv == pv == 3.0 and jb == pb


def test_pause_resume_gates_journaling(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=1, **SYNC))
        batches = _batches(S, 4)
        m.update(*batches[0])
        taken = [mgr.snapshots_taken]
        mgr.pause()
        m.update(*batches[1])
        taken.append(mgr.snapshots_taken)
        mgr.resume()
        m.update(*batches[2])
        taken.append(mgr.snapshots_taken)
        mgr.close()
        return taken

    j, p = both(run)
    assert j == p and p[0] == p[1] < p[2]


def test_mid_stream_reset_is_journaled_and_replayed(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=100, **SYNC))
        batches = _batches(S, 6)
        for p, t in batches[:3]:
            m.update(p, t)
        m.reset()
        for p, t in batches[3:]:
            m.update(p, t)
        expected = host(m.compute())
        mgr.simulate_preemption()
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            report = mgr2.restore_latest()
        close(fresh.compute(), expected)
        again = _mse(S)  # restore's own reset() is not journaled: a second restore lands on the same state
        with S.res.SnapshotManager(again, dirs[S.name], _policy(S, **SYNC)) as mgr3:
            mgr3.restore_latest()
        close(again.compute(), expected)
        return fresh._update_count, report.replayed

    assert both(run) == ((3, 6), (3, 6))


def test_collection_mid_stream_reset_restores(dirs):
    def run(S):
        coll = _pair(S)
        mgr = S.res.SnapshotManager(coll, dirs[S.name], _policy(S, every_n_updates=100, **SYNC))
        batches = _batches(S, 4)
        for p, t in batches[:2]:
            coll.update(p, t)
        coll.reset()
        for p, t in batches[2:]:
            coll.update(p, t)
        expected = {k: host(v) for k, v in coll.compute().items()}
        mgr.simulate_preemption()
        fresh = _pair(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            mgr2.restore_latest()
        got = {k: host(v) for k, v in fresh.compute().items()}
        assert got.keys() == expected.keys()
        for k in got:
            close(got[k], expected[k])
        return got

    j, p = both(run)
    for k in p:
        close(j[k], p[k])


def _writers():
    return sum(1 for t in threading.enumerate() if t.name.startswith("tm-tpu-snapshot-writer") and t.is_alive())


def test_rejected_double_attach_leaks_no_writer_thread(dirs):
    for S in (JAX, PORT):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, async_write=True))
        before = _writers()
        for _ in range(3):
            with pytest.raises(ValueError, match="already has an active SnapshotManager"):
                S.res.SnapshotManager(m, dirs[S.name], _policy(S, async_write=True))
        assert _writers() == before
        mgr.close()


def test_total_restore_failure_rolls_back_live_state(dirs):
    def run(S):
        d = dirs[S.name]
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, d, _policy(S, every_n_updates=2, **SYNC))
        for p, t in _batches(S, 5):
            m.update(p, t)
        expected, count = host(m.compute()).copy(), m._update_count
        for s in _snaps(d):
            S.fi.corrupt_file(d / s, "bitflip", seed=3)
        with pytest.raises(S.res.SnapshotRestoreError):
            mgr.restore_latest()
        assert m._update_count == count
        close(m.compute(), expected)
        mgr.close()
        return count

    assert both(run) == (5, 5)


def test_class_mismatch_generation_is_rejected(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, every_n_updates=2, **SYNC))
        for p, t in _batches(S, 4):
            m.update(p, t)
        mgr.close()
        other = _mae(S)
        with S.res.SnapshotManager(other, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            with pytest.raises(S.res.SnapshotRestoreError) as err:
                mgr2.restore_latest()
        assert any("MeanSquaredError" in reason for reason in err.value.failures.values())
        return sorted(err.value.failures)

    j, p = both(run)
    assert j == p


def test_merge_state_is_journaled_and_replayed(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, **SYNC))
        bs = _batches(S, 4)
        for p, t in bs[:2]:
            m.update(p, t)
        shard = _mse(S)
        for p, t in bs[2:]:
            shard.update(p, t)
        m.merge_state(shard)
        expected = host(m.compute())
        mgr.simulate_preemption()
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            mgr2.restore_latest()
        close(fresh.compute(), expected)
        return fresh._update_count, m._update_count

    assert both(run) == ((4, 4), (4, 4))


def test_manual_mid_stream_load_survives_preemption(dirs):
    def run(S):
        m = _mse(S)
        mgr = S.res.SnapshotManager(m, dirs[S.name], _policy(S, **SYNC))
        bs = _batches(S, 6)
        for p, t in bs[:2]:
            m.update(p, t)
        donor = _mse(S)
        for p, t in bs[2:4]:
            donor.update(p, t)
        m.load_state_dict(donor.state_dict())
        for p, t in bs[4:]:
            m.update(p, t)
        expected = host(m.compute())
        mgr.simulate_preemption()
        fresh = _mse(S)
        with S.res.SnapshotManager(fresh, dirs[S.name], _policy(S, **SYNC)) as mgr2:
            report = mgr2.restore_latest()
        close(fresh.compute(), expected)
        return report.replayed

    assert both(run) == (2, 2)  # only the post-load updates replay


def test_writer_drain_after_close_returns_immediately(dirs):
    for S in (JAX, PORT):
        metric = _mse(S)
        mgr = S.res.SnapshotManager(metric, dirs[S.name], _policy(S, async_write=True))
        metric.update(S.arr(np.ones(4, np.float32)), S.arr(np.zeros(4, np.float32)))
        mgr.close()
        t0 = time.perf_counter()
        mgr.flush()
        assert time.perf_counter() - t0 < 1.0


def test_writer_refuses_jobs_after_close():
    for S in (JAX, PORT):
        w = S.snapshot._Writer()
        ran = []
        w.submit(lambda: ran.append(1))
        w.drain()
        w.close()
        with pytest.raises(RuntimeError, match="closed"):
            w.submit(lambda: ran.append(2))
        assert ran == [1]
        w.close()  # idempotent


def test_closed_manager_degrades_not_corrupts_on_late_snapshot(dirs):
    for S in (JAX, PORT):
        metric = _mse(S)
        mgr = S.res.SnapshotManager(metric, dirs[S.name], _policy(S, async_write=True))
        metric.update(S.arr(np.ones(4, np.float32)), S.arr(np.zeros(4, np.float32)))
        mgr.close()
        with pytest.raises(RuntimeError, match="closed"):
            mgr.snapshot_now()


# ------------------------------------------------------- added for the port
def _stream_into(S, target, d, batches, kill_at):
    mgr = S.res.SnapshotManager(target, d, _policy(S, every_n_updates=4, keep=2, **SYNC))
    for p, t in batches[:kill_at]:
        target.update(p, t)
    mgr.simulate_preemption()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("target", ["metric", "collection"])
def test_snapshot_directory_restores_across_packages(tmp_path, writer, target):
    """One package writes snapshots and a journal and is killed; the other restores them, then both stream on."""
    src, dst = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    make = _mse if target == "metric" else _pair
    rng = np.random.default_rng(9)
    raw = [(rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)) for _ in range(10)]
    batches = {S.name: [(S.arr(p), S.arr(t)) for p, t in raw] for S in (JAX, PORT)}
    live = make(src)
    _stream_into(src, live, tmp_path, batches[src.name], kill_at=7)
    restored = make(dst)
    with dst.res.SnapshotManager(restored, tmp_path, _policy(dst, **SYNC)) as mgr:
        report = mgr.restore_latest()
    assert not report.fell_back and report.replayed == 2  # snapshots after updates 1 and 5; updates 6 and 7 replay
    for p, t in batches[dst.name][7:]:
        restored.update(p, t)
    golden = make(dst)
    for p, t in batches[dst.name]:
        golden.update(p, t)
    got, want = restored.compute(), golden.compute()
    if target == "metric":
        close(got, want, rtol=1e-6)
    else:
        for k in want:
            close(got[k], want[k], rtol=1e-6)


def test_replayed_journal_goes_back_through_the_compiled_update(tmp_path):
    """The restored stream replays through the compiled step and equals an uninterrupted compiled stream bit for bit."""
    rng = np.random.default_rng(12)
    batches = [(torch.from_numpy(rng.normal(size=16).astype(np.float32)),
                torch.from_numpy(rng.normal(size=16).astype(np.float32))) for _ in range(12)]
    plain = PORT.tm.MeanSquaredError(device="cpu")
    for p, t in batches:
        plain.update(p, t)
    assert "_auto_update_fn" in plain.__dict__
    live = PORT.tm.MeanSquaredError(device="cpu")
    mgr = PORT.res.SnapshotManager(live, tmp_path, PORT.res.SnapshotPolicy(every_n_updates=4, **SYNC))
    for p, t in batches[:8]:
        live.update(p, t)
    mgr.simulate_preemption()
    fresh = PORT.tm.MeanSquaredError(device="cpu")
    seen = []
    real = type(fresh)._run_compiled

    def counting(self, cache_name, *args, **kwargs):
        seen.append(cache_name)
        return real(self, cache_name, *args, **kwargs)

    type(fresh)._run_compiled = counting
    try:
        with PORT.res.SnapshotManager(fresh, tmp_path, PORT.res.SnapshotPolicy(**SYNC)) as mgr2:
            report = mgr2.restore_latest()
            for p, t in batches[8:]:
                fresh.update(p, t)
    finally:
        type(fresh)._run_compiled = real
    # snapshots after updates 1 and 5; updates 6-8 replay, the second of them through the compiled step
    assert report.replayed == 3 and len(seen) == 2 + 4
    for key in plain._defaults:
        assert torch.equal(getattr(fresh, key), getattr(plain, key)), key
    assert torch.equal(fresh.compute(), plain.compute())


def test_snapshot_payload_is_torch_free(tmp_path):
    """Snapshot and journal pickles hold numpy (and the port's numpy-only bf16 holder), never a tensor."""
    m = PORT.tm.MeanSquaredError(device="cpu")
    mgr = PORT.res.SnapshotManager(m, tmp_path, PORT.res.SnapshotPolicy(every_n_updates=100, **SYNC))
    for _ in range(3):
        m.update(torch.randn(4), torch.randn(4))
    mgr.close()

    class NoTorch(pickle.Unpickler):
        def find_class(self, module, name):
            assert not module.startswith("torch"), (module, name)
            return super().find_class(module, name)

    import io

    snap = (tmp_path / _snaps(tmp_path)[0]).read_bytes()
    NoTorch(io.BytesIO(snap[8 + 32:])).load()
    raw = (tmp_path / _journals(tmp_path)[-1]).read_bytes()
    NoTorch(io.BytesIO(raw[12:])).load()
