"""The port's guarded sync against the JAX package's, on the CPU.

From ``tests/unittests/resilience/test_guarded_sync.py``: handshake,
retry/backoff, the watchdog and degradation, each scenario run through both
packages in a simulated world (the transport seam of
``utilities/distributed.py``). Every policy timeout is 0.5 s or less, and no
test waits on a stall longer than its own timeout. Added for the port: a real
two-process gloo world (a guarded sync, a handshake that fails on
``num_classes`` 3 against 5, ``gather_all_tensors`` unchanged by the seam, a
guarded sync on a one-rank subgroup), the watchdog's attempt on the caller's
card, and the compiled path's routing with no policy attached.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_resilience_integrity import JAX, PORT, both, host, quiet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fast(S, **kw):
    """3 attempts, ~10 ms of backoff in all, a 0.2 s watchdog."""
    return S.res.SyncPolicy(retry=S.res.RetryPolicy(max_retries=2, timeout=0.2, backoff_base=0.005, backoff_max=0.02), **kw)


def _acc(S, **kw):
    return S.tm.classification.MulticlassAccuracy(num_classes=3, validate_args=False, **S.kw, **kw)


@pytest.fixture(autouse=True)
def _no_warning_noise():
    with quiet():
        yield


# ------------------------------------------------------------------ happy path
def test_guarded_sync_matches_unguarded():
    def run(S):
        with S.fi.simulated_world(2):
            guarded, plain = S.DummySum(sync_policy=S.res.SyncPolicy(), **S.kw), S.DummySum(**S.kw)
            for m in (guarded, plain):
                m.update(3.0)
            return float(host(guarded.compute())), float(host(plain.compute()))

    assert both(run) == ((6.0, 6.0), (6.0, 6.0))


def test_no_exception_no_event_on_happy_path():
    def run(S):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=S.res.SyncPolicy(), **S.kw)
            m.update(1.0)
            float(host(m.compute()))
            report = m.resilience_report()
            return report.healthy, report.events, report.degraded_syncs

    assert both(run) == ((True, (), 0), (True, (), 0))


def test_single_process_sync_is_noop():
    def run(S):
        m = S.DummySum(sync_policy=S.res.SyncPolicy(), **S.kw)
        m.update(2.0)
        return float(host(m.compute())), m.resilience_report().healthy

    assert both(run) == ((2.0, True), (2.0, True))


def test_default_policy_process_wide():
    def run(S):
        S.res.set_default_sync_policy(S.res.SyncPolicy())
        try:
            with S.fi.simulated_world(2):
                m = S.DummySum(**S.kw)  # no policy of its own: inherits the default
                m.update(1.0)
                with S.fi.inject_collective_failure(first_n=0) as stats:
                    value = float(host(m.compute()))
                return value, stats.calls  # handshake + shape + data
        finally:
            S.res.set_default_sync_policy(None)

    assert both(run) == ((2.0, 3), (2.0, 3))


def test_explicit_none_opts_out_of_default_policy():
    for S in (JAX, PORT):
        S.res.set_default_sync_policy(fast(S))
        try:
            with S.fi.simulated_world(2):
                opted_out = S.DummySum(sync_policy=None, **S.kw)
                opted_out.update(1.0)
                with S.fi.inject_collective_failure(first_n=99), pytest.raises(ConnectionError):
                    opted_out.sync()  # raw, not degraded
                assert opted_out.resilience_report().healthy
                revoked = S.DummySum(sync_policy=fast(S), **S.kw).set_resilience_policy(sync_policy=None)
                revoked.update(1.0)
                with S.fi.inject_collective_failure(first_n=99), pytest.raises(ConnectionError):
                    revoked.sync()
        finally:
            S.res.set_default_sync_policy(None)


def test_stateful_metric_guarded_sync():
    def run(S):
        with S.fi.simulated_world(2):
            guarded, plain = _acc(S, sync_policy=S.res.SyncPolicy()), _acc(S)
            for m in (guarded, plain):
                m.update(S.arr([0, 1, 2, 1]), S.arr([0, 1, 1, 1]))
            return float(host(guarded.compute())), float(host(plain.compute()))

    (jg, jp), (pg, pp) = both(run)
    assert jg == pytest.approx(jp) and pg == pytest.approx(pp) and pg == pytest.approx(jg)


# ----------------------------------------------------------- timeout, retry, degrade
def test_injected_timeout_degrades_without_hang():
    def run(S):
        policy = fast(S)
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=policy, **S.kw)
            m.update(3.0)
            start = time.perf_counter()
            with S.fi.inject_collective_timeout(first_n=99, hang=30.0) as stats:
                value = float(host(m.compute()))  # compute syncs: must neither hang nor raise
            elapsed = time.perf_counter() - start
        report = m.resilience_report()
        event = report.events[0]
        assert elapsed < 5.0, f"degradation took {elapsed:.1f}s"
        assert stats.injected >= policy.retry.attempts
        return value, report.degraded_syncs, event.kind, event.attempts

    j, p = both(run)
    assert j == p and p[0] == 3.0 and p[1] == 1 and p[3] == 3
    assert p[2] in ("sync_degraded", "handshake_degraded")


def test_gather_phase_timeout_degrades():
    def run(S):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=fast(S), **S.kw)
            m.update(1.0)
            m.sync()  # a clean first sync caches the handshake
            m.unsync()
            with S.fi.inject_collective_timeout(first_n=99, hang=30.0):
                m.sync()  # degraded, not raised
            return m._is_synced, float(host(m.x)), m.resilience_report().events[0].kind

    assert both(run) == ((False, 1.0, "sync_degraded"), (False, 1.0, "sync_degraded"))


def test_transient_failure_retries_to_success():
    def run(S):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=fast(S), **S.kw)
            m.update(2.0)
            with S.fi.inject_collective_failure(first_n=1) as stats:
                value = float(host(m.compute()))
            return value, stats.injected, stats.calls, m.resilience_report().healthy

    assert both(run) == ((4.0, 1, 4, True), (4.0, 1, 4, True))


def test_on_exhausted_raise_propagates():
    def run(S):
        policy = S.res.SyncPolicy(retry=fast(S).retry, on_exhausted="raise")
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=policy, **S.kw)
            m.update(1.0)
            with S.fi.inject_collective_failure(first_n=99), pytest.raises(S.res.SyncRetriesExhausted) as err:
                m.sync()
        return err.value.attempts

    assert both(run) == (3, 3)


def test_recovery_after_degradation():
    def run(S):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=fast(S), **S.kw)
            m.update(5.0)
            with S.fi.inject_collective_failure(first_n=99):
                m.sync()
            out = [m._is_synced, m.resilience_report().degraded_syncs]
            m.sync()  # the transport is healthy again
            out += [m._is_synced, float(host(m.x))]
            m.unsync()
            return out + [float(host(m.x))]

    assert both(run) == ([False, 1, True, 10.0, 5.0], [False, 1, True, 10.0, 5.0])


def _fused(S):
    class FusedSync(S.DummySum):
        def _sync_dist(self, dist_sync_fn, process_group=None):
            super()._sync_dist(dist_sync_fn, process_group=process_group)

    return FusedSync


def test_overridden_sync_dist_retry_does_not_double_reduce():
    def run(S):
        with S.fi.simulated_world(2):
            m = _fused(S)(sync_policy=fast(S), **S.kw)
            m.update(3.0)
            with S.fi.inject_collective_failure(first_n=1):
                m.sync()
            return float(host(m.x))

    assert both(run) == (6.0, 6.0)  # one world sum, not reduced twice


def test_on_exhausted_raise_restores_local_state():
    def run(S):
        policy = S.res.SyncPolicy(retry=fast(S).retry, on_exhausted="raise", handshake=False)
        with S.fi.simulated_world(2):
            m = _fused(S)(sync_policy=policy, **S.kw)
            m.update(3.0)
            with S.fi.inject_collective_failure(first_n=99), pytest.raises(S.res.SyncRetriesExhausted):
                m.sync()
            return float(host(m.x)), m._is_synced, m._cache is None

    assert both(run) == ((3.0, False, True), (3.0, False, True))


def test_programming_errors_fail_fast_not_degraded():
    for S in (JAX, PORT):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=S.res.SyncPolicy(handshake=False, retry=fast(S).retry), **S.kw)
            m.update(1.0)
            with pytest.raises(TypeError):
                m.sync(dist_sync_fn=lambda only_one_arg: [only_one_arg])
            assert float(host(m.x)) == 1.0 and not m.resilience_report().events


def test_backoff_schedule():
    for S in (JAX, PORT):
        retry = S.res.RetryPolicy(max_retries=3, backoff_base=0.1, backoff_factor=2.0, backoff_max=0.25)
        assert [retry.backoff(k) for k in range(3)] == [0.1, 0.2, 0.25] and retry.attempts == 4


# ----------------------------------------------------------------- handshake
def _is_digest_payload(S, arr):
    # the digest travels as two words: uint32 in the JAX package, int64 below 2**32 here
    return arr.shape == (2,) and arr.dtype == (np.uint32 if S is JAX else np.int64)


def test_structure_mismatch_fails_fast():
    def run(S):
        def mismatching(x):
            arr = host(x)
            stacked = np.stack([arr] * 2)
            if _is_digest_payload(S, arr):  # perturb only the handshake digest
                stacked = stacked.copy()
                stacked[1] ^= 1
            return stacked if S is JAX else torch.as_tensor(stacked)

        with S.fi.simulated_world(2, transport=mismatching):
            m = S.DummySum(sync_policy=S.res.SyncPolicy(), **S.kw)
            m.update(1.0)
            with pytest.raises(S.res.StateStructureMismatchError, match="structure digests"):
                m.sync()
            return float(host(m.x)), m._is_synced

    assert both(run) == ((1.0, False), (1.0, False))


def test_digest_survives_a_narrowing_transport():
    """``test_digest_survives_uint64_truncating_transport``: the port's words stay below 2**32, through int32 too."""
    def run(S):
        def narrowing(x):
            arr = host(x)
            if S is PORT and arr.dtype == np.int64:
                assert (arr < 2**32).all() and (arr >= 0).all()
                arr = arr.astype(np.uint32).astype(np.int64)  # what a 32-bit round trip would leave
            return np.stack([arr] * 2) if S is JAX else torch.as_tensor(np.stack([arr] * 2))

        with S.fi.simulated_world(2, transport=narrowing):
            m = S.DummySum(sync_policy=S.res.SyncPolicy(), **S.kw)
            m.update(2.0)
            return float(host(m.compute())), m.resilience_report().healthy

    assert both(run) == ((4.0, True), (4.0, True))


def test_handshake_digest_covers_structure():
    for S in (JAX, PORT):
        a, b = _acc(S), _acc(S)
        c = S.tm.classification.MulticlassAccuracy(num_classes=5, validate_args=False, **S.kw)
        digest = S.res.state_structure_digest
        assert digest(a)[0] == digest(b)[0] != digest(c)[0]


def test_handshake_cached_after_success():
    def run(S):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=S.res.SyncPolicy(), **S.kw)
            m.update(1.0)
            m.sync()
            m.unsync()
            with S.fi.inject_collective_failure(first_n=0) as stats:
                m.sync()
                m.unsync()
            return stats.calls  # shape + data gather only

    assert both(run) == (2, 2)


def test_cat_state_uneven_lengths_share_digest():
    for S in (JAX, PORT):
        a, b = S.DummyList(**S.kw), S.DummyList(**S.kw)
        b.update(S.arr(np.float32([1.0, 2.0, 3.0])))
        assert S.res.state_structure_digest(a)[0] == S.res.state_structure_digest(b)[0]


# ------------------------------------------------------- degradation ergonomics
def test_degraded_sync_makes_paired_unsync_a_noop():
    def run(S):
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=fast(S), **S.kw)
            m.update(2.0)
            with S.fi.inject_collective_failure(first_n=99):
                m.sync()  # degrades quietly
            m.unsync()  # nothing to undo, no raise
            out = [float(host(m.x))]
            m.sync()
            m.unsync()
            out.append(float(host(m.x)))
            with pytest.raises(Exception, match="already been un-synced"):
                m.unsync()  # a genuinely unpaired unsync still raises
            return out

    assert both(run) == ([2.0, 2.0], [2.0, 2.0])


def test_event_log_is_capped():
    def run(S):
        m = S.DummySum(**S.kw)
        for i in range(S.res.policy.MAX_EVENTS + 10):
            m._record_degradation("sync_degraded", detail=f"outage {i}")
        report = m.resilience_report()
        return len(report.events), report.dropped_events, report.events[-1].detail

    j, p = both(run)
    assert j == p == (64, 10, "outage 73")


def test_concurrent_guarded_syncs_do_not_share_timeout_budget():
    for S in (JAX, PORT):
        with S.fi.simulated_world(2):
            slow = S.DummySum(sync_policy=S.res.SyncPolicy(handshake=False, retry=S.res.RetryPolicy(timeout=0.5, max_retries=0)), **S.kw)
            fast_m = S.DummySum(sync_policy=S.res.SyncPolicy(handshake=False, retry=S.res.RetryPolicy(timeout=0.5, max_retries=0)), **S.kw)
            slow.update(1.0)
            fast_m.update(2.0)
            with S.fi.inject_collective_timeout(first_n=1, hang=2.0) as stats:
                t = threading.Thread(target=slow.sync, daemon=True)
                t.start()
                deadline = time.perf_counter() + 5.0
                while not stats.injected and time.perf_counter() < deadline:
                    time.sleep(0.005)  # until the stalled attempt holds a worker
                assert stats.injected == 1
                start = time.perf_counter()
                fast_m.sync()  # gets a worker of its own
                elapsed = time.perf_counter() - start
                t.join(timeout=5.0)
            assert fast_m._is_synced and float(host(fast_m.x)) == 4.0
            assert elapsed < 0.4, f"a concurrent sync waited {elapsed:.2f}s behind a stalled worker"
            fast_m.unsync()
            assert not slow._is_synced


def test_handshake_every_sync_regathers():
    def run(S):
        policy = S.res.SyncPolicy(handshake=True, handshake_every_sync=True, retry=fast(S).retry)
        with S.fi.simulated_world(2):
            m = S.DummySum(sync_policy=policy, **S.kw)
            m.update(1.0)
            m.sync()
            m.unsync()
            with S.fi.inject_collective_failure(first_n=0) as stats:
                m.sync()
                m.unsync()
            return stats.calls  # handshake + shape + data, every sync

    assert both(run) == (3, 3)


def test_policy_fans_out_to_members():
    for S in (JAX, PORT):
        policy = fast(S)
        mc = S.tm.MetricCollection([_acc(S)])
        mc.set_resilience_policy(sync_policy=policy, nan_policy="warn")
        for m in mc.values():
            assert m.sync_policy is policy and m.nan_policy == "warn"


def test_collection_degrades_member_wise():
    def run(S):
        with S.fi.simulated_world(2):
            mc = S.tm.MetricCollection([_acc(S)])
            mc.set_resilience_policy(sync_policy=fast(S))
            mc.update(S.arr([0, 1, 2]), S.arr([0, 1, 1]))
            with S.fi.inject_collective_failure(first_n=99):
                out = mc.compute()
            return sorted(out), mc.resilience_report()["MulticlassAccuracy"].degraded_syncs >= 1, float(host(out["MulticlassAccuracy"]))

    j, p = both(run)
    assert j[:2] == p[:2] == (["MulticlassAccuracy"], True)
    assert j[2] == pytest.approx(p[2])


# ------------------------------------------------------- added for the port
def test_real_timeout_ends_the_attempts(monkeypatch):
    """On the real transport a timed-out attempt is the last: the sync degrades without entering the group again."""
    m = PORT.DummySum(sync_policy=PORT.res.SyncPolicy(handshake=False, retry=PORT.res.RetryPolicy(timeout=0.1, max_retries=3, backoff_base=0.0)), device="cpu")
    m.update(1.0)
    release, calls = threading.Event(), []

    def stalled_gather(x, group=None):
        calls.append(1)
        release.wait(2.0)
        return [x]

    monkeypatch.setattr(PORT.dist, "distributed_available", lambda: True)
    try:
        m.sync(dist_sync_fn=stalled_gather, distributed_available=lambda: True)
    finally:
        release.set()
    (event,) = m.resilience_report().events
    assert calls == [1] and event.kind == "sync_degraded" and event.attempts == 1
    assert not m._is_synced and float(m.x) == 1.0


def test_watchdog_attempt_runs_on_the_callers_card(monkeypatch):
    """A timed attempt runs under the calling thread's current CUDA device, not a new thread's card 0."""
    current = threading.local()

    @contextlib.contextmanager
    def device(index):
        prev = getattr(current, "index", 0)
        current.index = index
        try:
            yield
        finally:
            current.index = prev

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: getattr(current, "index", 0))
    monkeypatch.setattr(torch.cuda, "device", device)
    seen = []

    def recording_gather(x, group=None):
        seen.append((torch.cuda.current_device(), threading.get_ident()))
        return [x]

    m = PORT.DummySum(sync_policy=PORT.res.SyncPolicy(handshake=False, retry=PORT.res.RetryPolicy(timeout=0.5)), device="cpu")
    m.update(1.0)
    current.index = 1  # as `torch.cuda.set_device(local_rank)` leaves a rank on card 1
    try:
        m.sync(dist_sync_fn=recording_gather, distributed_available=lambda: True)
    finally:
        current.index = 0
    assert seen and seen[0][1] != threading.get_ident()  # the attempt ran on the watchdog's worker
    assert [index for index, _ in seen] == [1] and m._is_synced and m.resilience_report().healthy


_WORLD_WORKER = r"""
import json, sys, warnings
import numpy as np, torch, torch.distributed as dist
warnings.simplefilter("ignore")
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
from torchmetrics_tpu_torch._resilience import RetryPolicy, StateStructureMismatchError, SyncPolicy
from torchmetrics_tpu_torch.utilities import gather_all_tensors
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
out = {}
try:
    policy = SyncPolicy(retry=RetryPolicy(timeout=0.5, max_retries=0))
    out["gathered"] = [g.tolist() for g in gather_all_tensors(torch.arange(rank + 2).reshape(-1, 1) * (rank + 1))]
    rng = np.random.default_rng(rank)
    m = MulticlassConfusionMatrix(num_classes=7, device="cpu", sync_policy=policy)
    m.update(torch.from_numpy(rng.integers(0, 7, 64)), torch.from_numpy(rng.integers(0, 7, 64)))
    local = m.confmat.clone()
    out["synced"] = m.compute().tolist()
    out["local_restored"] = bool(torch.equal(m.confmat, local))
    out["healthy"] = m.resilience_report().healthy
    bad = MulticlassConfusionMatrix(num_classes=3 if rank == 0 else 5, device="cpu", sync_policy=policy)
    bad.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    try:
        bad.sync()
        out["mismatch"] = None
    except StateStructureMismatchError as err:
        out["mismatch"] = str(err)
    out["bad_kept_local"] = bool(bad.confmat.sum() == 3) and not bad._is_synced
    # a sync on a subgroup: the handshake and the gather stay inside it, while rank 1 joins no collective
    sub = dist.new_group([0])
    if rank == 0:
        solo = MulticlassConfusionMatrix(num_classes=7, device="cpu", sync_policy=policy)
        solo.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        solo.sync(process_group=sub)
        out["subgroup"] = [solo._is_synced, solo.resilience_report().healthy, int(solo.confmat.sum())]
    dist.barrier()
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo_guarded_sync_and_handshake():
    """A real gloo world: a guarded sync sums the ranks, a 3-class against 5-class handshake fails fast."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORLD_WORKER, str(rank), "2", str(port)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    want = np.zeros((7, 7), np.int64)
    for rank in range(2):
        rng = np.random.default_rng(rank)
        p, t = rng.integers(0, 7, 64), rng.integers(0, 7, 64)
        np.add.at(want, (t, p), 1)
    for out in outs:
        assert out["gathered"] == [[[0], [1]], [[0], [2], [4]]]  # uneven shapes, padded and trimmed as before
        assert np.array_equal(np.asarray(out["synced"]), want) and out["local_restored"] and out["healthy"]
        assert out["mismatch"] is not None and "structure digests" in out["mismatch"]
        assert out["bad_kept_local"]
    assert outs[0]["subgroup"] == [True, True, 3] and "subgroup" not in outs[1]


def test_compiled_routing_unchanged_without_a_policy():
    """No policy, no manager: the compiled path engages as before, and a forward or update journals nothing."""
    m = PORT.tm.MeanSquaredError(device="cpu")
    p, t = torch.ones(8), torch.zeros(8)
    for _ in range(3):
        m.update(p, t)
    m(p, t)
    m(p, t)
    assert "_auto_update_fn" in m.__dict__ and "_auto_forward_fn" in m.__dict__ and not m._auto_disabled
    assert m.sync_policy is None and m.nan_policy is None and m.__dict__["_snapshot_hook"] is None
    assert m._update_count == 5
