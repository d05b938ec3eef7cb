"""The port's per-stream sharded durability against the JAX package's, on the CPU.

From ``tests/unittests/streams/test_durability.py`` (6 tests): a tenant's
restore replays only its tagged journal frames, ``restore_latest`` rebuilds
the whole pool with its lifecycle, a tenant attached after the snapshot
restores from its journal alone, a corrupt newest snapshot falls back, an
empty directory raises, the untagged record path is sealed. Each scenario
runs through both packages on the same seeded numpy batches and the restored
values and reports are compared. Added for the port: the journal frames are
the JAX package's (``<I8sH`` header, int32 ids), so a directory written by
one package restores a stream in the other.
"""

import numpy as np
import pytest

import torchmetrics_tpu._resilience as j_res
import torchmetrics_tpu._resilience.faultinject as j_faultinject
import torchmetrics_tpu_torch._resilience as t_res
import torchmetrics_tpu_torch._resilience.faultinject as t_faultinject
from tests.test_torch_streams_pool import JAX, PORT, close, host

N_STREAMS = 64
RES = {JAX.name: j_res, PORT.name: t_res}
FAULTS = {JAX.name: j_faultinject, PORT.name: t_faultinject}


def _batches(n_calls, sizes, seed=123, n=8):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((b, n)).astype(np.float32), rng.standard_normal((b, n)).astype(np.float32))
        for b in (sizes if isinstance(sizes, list) else [sizes] * n_calls)
    ]


def _pool(S, capacity=N_STREAMS):
    return S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=capacity)


def _policy(S, **kw):
    return RES[S.name].SnapshotPolicy(**kw)


def _members(step, sids):
    return sids[step % 4 :: 2 + step % 3]


def test_restore_stream_replays_only_that_streams_segment(tmp_path):
    """Interleaved multi-tenant traffic, a preemption, then one tenant's restore replays only its frames."""
    sids = list(range(N_STREAMS))
    batches = _batches(12, [len(_members(step, sids)) for step in range(12)])

    def run(S):
        d = tmp_path / S.name
        pool = _pool(S)
        mgr = S.streams.StreamSnapshotManager(
            pool, d, _policy(S, every_n_updates=1000, journal_max_entries=1000, async_write=False)
        )
        eagers = {pool.attach(): S.tm.MeanSquaredError(**S.kw) for _ in range(N_STREAMS)}
        segment = {sid: 0 for sid in eagers}
        total_update_frames = 0
        for step in range(12):
            ids = np.asarray(_members(step, sorted(eagers)), dtype=np.int32)
            p, t = batches[step]
            pool.update(ids, S.arr(p), S.arr(t))
            for b, sid in enumerate(ids.tolist()):
                eagers[sid].update(S.arr(p[b]), S.arr(t[b]))
                if step:
                    # the first journaled call anchors the base snapshot instead of a frame
                    segment[sid] += 1
            total_update_frames += bool(step)
        mgr.simulate_preemption()

        victim = sorted(eagers)[5]
        fresh = _pool(S)
        mgr2 = S.streams.StreamSnapshotManager(fresh, d, _policy(S, async_write=False))
        for _ in range(N_STREAMS):
            fresh.attach()
        report = mgr2.restore_stream(victim)
        assert report.stream == victim
        assert report.replayed == segment[victim]
        assert report.replayed < total_update_frames
        close(fresh.compute(victim), eagers[victim].compute(), rtol=1e-5)
        assert fresh.stream_update_count(victim) == segment[victim]
        # undisturbed slots stay at their defaults (their restore is theirs to request)
        assert fresh.stream_update_count(sorted(eagers)[6]) == 0
        mgr2.close()
        return report.replayed, report.generation, host(fresh.compute(victim))

    j, p = (run(JAX), run(PORT))
    assert j[:2] == p[:2]
    close(j[2], p[2])


def test_restore_latest_rebuilds_whole_pool_with_lifecycle(tmp_path):
    batches = _batches(9, 6, seed=7)

    def run(S):
        d = tmp_path / S.name
        pool = _pool(S, capacity=8)
        mgr = S.streams.StreamSnapshotManager(pool, d, _policy(S, every_n_updates=4, async_write=False))
        eagers = {pool.attach(): S.tm.MeanSquaredError(**S.kw) for _ in range(6)}
        for step in range(9):
            ids = np.asarray(sorted(eagers), dtype=np.int32)
            p, t = batches[step]
            pool.update(ids, S.arr(p), S.arr(t))
            for b, sid in enumerate(ids.tolist()):
                eagers[sid].update(S.arr(p[b]), S.arr(t[b]))
            if step == 4:
                # lifecycle rides the journal: detach one tenant, reset another, attach a new one
                victim = sorted(eagers)[0]
                pool.detach(victim)
                del eagers[victim]
                resettee = sorted(eagers)[0]
                pool.reset(resettee)
                eagers[resettee] = S.tm.MeanSquaredError(**S.kw)
                eagers[pool.attach()] = S.tm.MeanSquaredError(**S.kw)
        mgr.simulate_preemption()

        fresh = _pool(S, capacity=8)
        mgr2 = S.streams.StreamSnapshotManager(fresh, d, _policy(S, async_write=False))
        report = mgr2.restore_latest()
        assert report.replayed > 0
        assert fresh.active_streams == sorted(eagers)
        for sid, eager in eagers.items():
            close(fresh.compute(sid), eager.compute(), rtol=1e-5)
        mgr2.close()
        return report.replayed, fresh.active_streams, {sid: host(fresh.compute(sid)) for sid in eagers}

    j, p = run(JAX), run(PORT)
    assert j[:2] == p[:2]
    for sid in j[2]:
        close(j[2][sid], p[2][sid])


def test_restore_stream_attached_after_snapshot_starts_from_journal(tmp_path):
    """A tenant attached after the loaded snapshot restores from its journal segment alone."""
    (p1, t1), (p2, t2) = _batches(2, 1, seed=11)

    def run(S):
        d = tmp_path / S.name
        pool = _pool(S, capacity=4)
        mgr = S.streams.StreamSnapshotManager(
            pool, d, _policy(S, every_n_updates=1000, journal_max_entries=1000, async_write=False)
        )
        s0 = pool.attach()
        pool.update(np.array([s0], np.int32), S.arr(p1), S.arr(t1))  # anchors the base snapshot
        late = pool.attach()  # a journaled lifecycle record
        eager = S.tm.MeanSquaredError(**S.kw)
        pool.update(np.array([late], np.int32), S.arr(p2), S.arr(t2))
        eager.update(S.arr(p2[0]), S.arr(t2[0]))
        mgr.simulate_preemption()

        fresh = _pool(S, capacity=4)
        mgr2 = S.streams.StreamSnapshotManager(fresh, d, _policy(S, async_write=False))
        fresh.attach()
        fresh.attach()
        report = mgr2.restore_stream(late)
        assert report.replayed == 2  # the attach boundary and one tagged update frame
        close(fresh.compute(late), eager.compute(), rtol=1e-5)
        mgr2.close()
        return host(fresh.compute(late))

    j, p = run(JAX), run(PORT)
    close(j, p)


def test_corrupt_newest_snapshot_falls_back(tmp_path):
    batches = _batches(6, 2, seed=13)

    def run(S):
        d = tmp_path / S.name
        pool = _pool(S, capacity=4)
        mgr = S.streams.StreamSnapshotManager(pool, d, _policy(S, every_n_updates=2, async_write=False))
        eagers = {pool.attach(): S.tm.MeanSquaredError(**S.kw) for _ in range(2)}
        for p, t in batches:
            ids = np.asarray(sorted(eagers), dtype=np.int32)
            pool.update(ids, S.arr(p), S.arr(t))
            for b, sid in enumerate(ids.tolist()):
                eagers[sid].update(S.arr(p[b]), S.arr(t[b]))
        mgr.simulate_preemption()
        newest = max(int(f.name[5:13]) for f in d.iterdir() if f.name.startswith("snap-"))
        FAULTS[S.name].corrupt_file(d / f"snap-{newest:08d}.ckpt")

        fresh = _pool(S, capacity=4)
        mgr2 = S.streams.StreamSnapshotManager(fresh, d, _policy(S, async_write=False))
        for _ in range(2):
            fresh.attach()
        report = mgr2.restore_stream(0)
        assert report.skipped, "the corrupted newest generation must be recorded as skipped"
        close(fresh.compute(0), eagers[0].compute(), rtol=1e-5)
        mgr2.close()
        return sorted(report.skipped), report.generation, host(fresh.compute(0))

    j, p = run(JAX), run(PORT)
    assert j[:2] == p[:2]
    close(j[2], p[2])


def test_restore_stream_nothing_on_disk_raises(tmp_path):
    def run(S):
        pool = _pool(S, capacity=2)
        mgr = S.streams.StreamSnapshotManager(pool, tmp_path / S.name, _policy(S, async_write=False))
        pool.attach()
        with pytest.raises(RES[S.name].SnapshotRestoreError):
            mgr.restore_stream(0)
        mgr.close()

    run(JAX)
    run(PORT)


def test_base_record_path_is_sealed(tmp_path):
    def run(S):
        pool = _pool(S, capacity=2)
        mgr = S.streams.StreamSnapshotManager(pool, tmp_path / S.name, _policy(S, async_write=False))
        with pytest.raises(TypeError, match="record_streams"):
            mgr.record(pool, "update", (), {})
        mgr.close()

    run(JAX)
    run(PORT)


@pytest.mark.parametrize(("writer", "reader"), [(JAX, PORT), (PORT, JAX)])
def test_a_journal_written_by_one_package_restores_a_stream_in_the_other(tmp_path, writer, reader):
    batches = _batches(5, 3, seed=17)
    pool = _pool(writer, capacity=4)
    mgr = writer.streams.StreamSnapshotManager(
        pool, tmp_path, _policy(writer, every_n_updates=1000, journal_max_entries=1000, async_write=False)
    )
    for _ in range(3):
        pool.attach()
    for p, t in batches:
        pool.update(np.arange(3, dtype=np.int32), writer.arr(p), writer.arr(t))
    want = host(pool.compute(1))
    mgr.simulate_preemption()

    fresh = _pool(reader, capacity=4)
    mgr2 = reader.streams.StreamSnapshotManager(fresh, tmp_path, _policy(reader, async_write=False))
    for _ in range(3):
        fresh.attach()
    report = mgr2.restore_stream(1)
    assert report.replayed == len(batches) - 1 and not report.fell_back
    close(fresh.compute(1), want, rtol=1e-6)
    mgr2.close()
