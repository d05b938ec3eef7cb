"""The port's serving runtime against the JAX package's (``tests/unittests/serving/test_serving_runtime.py``).

The classes below are the counterparts of the JAX suite's tests of the
ingress queue, the ack, the controller's configuration and the
``MetricServer`` end to end, on CPU metrics (``device="cpu"``), with the
same schedules. Beside them:

- golden equality: the same concurrent multi-stream requests through the
  port's server, the JAX package's server and eager replicas give every
  tenant the same value (rtol 1e-6: float32 sums of the same rows);
- the telemetry counters of one scripted run, key for key and value for
  value, against the JAX server's;
- the port's divergences by design, each asserted: no lock sanitizer,
  ``warm``'s outcomes, what an ack guarantees, the worker's device, and
  tensors taken to the host before stacking.

The JAX fixture arms its lock sanitizer; the port has none, so the fixture
here arms telemetry the same way and asserts after each test that every
server it saw was stopped, no ingest worker thread is alive, and no ack is
left pending.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tt
from torchmetrics_tpu_torch._observability import (
    BUS,
    REGISTRY,
    set_telemetry_enabled,
    set_telemetry_sampling,
)
from torchmetrics_tpu_torch._observability.state import DEFAULT_SAMPLE_EVERY
from torchmetrics_tpu_torch._serving import (
    Ack,
    BackpressureError,
    BatchController,
    ControllerConfig,
    IngressQueue,
    MetricServer,
    ServerClosedError,
    UpdateRequest,
)
from torchmetrics_tpu_torch._serving import runtime as port_runtime

RTOL = 1e-6


def _ingest_threads():
    return [t for t in threading.enumerate() if t.name == "tm-serving-ingest" and t.is_alive()]


@pytest.fixture()
def serving_env(monkeypatch):
    """Telemetry armed for every serving test; after it, no worker alive and no ack pending."""
    set_telemetry_enabled(True)
    set_telemetry_sampling(1)
    acks = []
    submit = MetricServer.submit

    def recording_submit(self, *args, **kwargs):
        ack = submit(self, *args, **kwargs)
        acks.append(ack)
        return ack

    monkeypatch.setattr(MetricServer, "submit", recording_submit)
    yield acks
    try:
        assert _ingest_threads() == [], "an ingest worker outlived its test"
        assert [a.state for a in acks if a.state == "pending"] == []
    finally:
        set_telemetry_enabled(False)
        set_telemetry_sampling(DEFAULT_SAMPLE_EVERY)
        REGISTRY.reset()
        BUS.clear()


def _req(sid=0):
    return UpdateRequest(sid, (np.zeros(4, dtype=np.float32),), {})


def _mse(**kw):
    return tt.MeanSquaredError(device="cpu", **kw)


# ------------------------------------------------------------- IngressQueue
class TestIngressQueue:
    def test_fifo_order_and_depth(self, serving_env):
        q = IngressQueue(capacity=8)
        reqs = [_req(i) for i in range(3)]
        for r in reqs:
            q.put(r)
        assert q.depth == 3
        assert [q.get(timeout=0.1) for _ in range(3)] == reqs
        assert q.depth == 0
        assert q.get(timeout=0.01) is None

    def test_full_queue_rejects_synchronously_with_retry_hint(self, serving_env):
        q = IngressQueue(capacity=2)
        q.put(_req(0))
        q.put(_req(1))
        with pytest.raises(BackpressureError) as exc:
            q.put(_req(2))
        assert exc.value.kind == "full"
        assert exc.value.retry_after_s > 0.0
        assert q.depth == 2  # the rejected request never occupied a slot

    def test_retry_after_tracks_live_drain_rate(self, serving_env):
        q = IngressQueue(capacity=4)
        for i in range(4):
            q.put(_req(i))
        cold = q.retry_after()  # no drain evidence: pessimistic clamp
        q.note_drained(rows=100, elapsed_s=0.1)  # 1000 rows/s
        warm = q.retry_after()
        assert warm < cold
        assert abs(warm - 4 / 1000.0) < 0.05  # depth / EWMA rate

    def test_shedding_rejects_but_admits_one_canary(self, serving_env):
        q = IngressQueue(capacity=8)
        BUS.clear()
        assert q.set_shedding(True)
        q.put(_req(0))  # empty queue: the canary probe is admitted
        assert q.depth == 1
        with pytest.raises(BackpressureError) as exc:
            q.put(_req(1))
        assert exc.value.kind == "shed"

    def test_shed_transitions_publish_once_each(self, serving_env):
        q = IngressQueue(capacity=8)
        BUS.clear()
        assert q.set_shedding(True)
        assert not q.set_shedding(True)
        for i in range(3):
            with pytest.raises(BackpressureError):
                q.put(_req(0))
                q.put(_req(1))
        assert q.set_shedding(False)
        assert not q.set_shedding(False)
        entered = BUS.events(kind="load_shed")
        exited = BUS.events(kind="load_shed_recovered")
        assert len(entered) == 1 and len(exited) == 1
        assert entered[0].data["seam"] == "serving.ingress"
        assert entered[0].data["episode"] == 1
        assert q.shed_episodes == 1

    def test_requeue_bypasses_admission(self, serving_env):
        q = IngressQueue(capacity=1)
        q.put(_req(0))
        q.set_shedding(True)
        q.requeue(_req(1))
        assert q.depth == 2

    def test_wake_unblocks_get(self, serving_env):
        q = IngressQueue(capacity=2)
        got = []
        t = threading.Thread(target=lambda: got.append(q.get(timeout=5.0)))
        t.start()
        q.wake()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert got == [None]

    def test_capacity_validation(self, serving_env):
        with pytest.raises(ValueError, match="capacity"):
            IngressQueue(capacity=0)


# --------------------------------------------------------------------- Ack
class TestAck:
    def test_resolution_publishes_fields(self, serving_env):
        ack = Ack()
        assert ack.state == "pending" and not ack.wait(timeout=0.01)
        ack._resolve("acked", latency_s=0.25, quarantined=True)
        assert ack.wait(timeout=1.0)
        assert ack.result() == "acked"
        assert ack.acked and ack.quarantined and ack.latency_s == 0.25

    def test_failed_result_reraises_worker_error(self, serving_env):
        ack = Ack()
        ack._resolve("failed", error=ValueError("boom"))
        with pytest.raises(ValueError, match="boom"):
            ack.result()

    def test_timeout_raises(self, serving_env):
        with pytest.raises(TimeoutError):
            Ack().result(timeout=0.01)


# ------------------------------------------------------------- config law
class TestControllerConfig:
    def test_validation(self, serving_env):
        with pytest.raises(ValueError, match="min_batch"):
            ControllerConfig(min_batch=0)
        with pytest.raises(ValueError, match="min_batch"):
            ControllerConfig(min_batch=8, max_batch=4)
        with pytest.raises(ValueError, match="shrink_factor"):
            ControllerConfig(shrink_factor=1.0)
        with pytest.raises(ValueError, match="grow_step"):
            ControllerConfig(grow_step=0)

    def test_interval_gate(self, serving_env):
        ctl = BatchController(ControllerConfig(interval_s=60.0))
        assert ctl.maybe_decide(queue_depth=0) is not None
        assert ctl.maybe_decide(queue_depth=0) is None


# ------------------------------------------------------------ MetricServer
class TestMetricServer:
    def _server(self, **kw):
        kw.setdefault("capacity", 8)
        kw.setdefault("queue_capacity", 64)
        kw.setdefault("controller", ControllerConfig(max_batch=8, interval_s=0.01))
        return MetricServer(_mse(nan_policy="quarantine"), **kw)

    def test_end_to_end_golden_equality(self, serving_env):
        """Concurrent multi-stream ingest computes exactly what per-stream
        eager replicas compute, while scrapes and reads run mid-ingest."""
        rng = np.random.default_rng(0)
        srv = self._server()
        sids = [srv.attach_stream() for _ in range(4)]
        outcomes = srv.warm(
            rng.normal(size=(16,)).astype(np.float32),
            rng.normal(size=(16,)).astype(np.float32),
        )
        for bucket in (1, 2, 4, 8):
            assert outcomes[f"{bucket}:stream_step"] == "compiled"
        with srv:
            golden = {sid: [] for sid in sids}
            acks = []
            for _ in range(10):
                for sid in sids:
                    p = rng.normal(size=(16,)).astype(np.float32)
                    t = rng.normal(size=(16,)).astype(np.float32)
                    golden[sid].append((p, t))
                    acks.append(srv.submit(sid, p, t))
            scrape_mid = srv.scrape()
            for ack in acks:
                assert ack.result(timeout=30.0) == "acked"
            assert all(ack.latency_s is not None for ack in acks)
            for sid in sids:
                eager = _mse()
                for p, t in golden[sid]:
                    eager.update(torch.from_numpy(p), torch.from_numpy(t))
                assert float(srv.compute(sid)) == pytest.approx(float(eager.compute()), rel=1e-5)
            assert set(srv.compute_all()) == set(sids)
            final = srv.scrape()
        assert "tmtpu_serving_batches_total" in final
        assert "tmtpu_serving_batch_rows_total" in final
        assert isinstance(scrape_mid, str)
        assert srv.rows_applied >= 40  # 40 client rows (+ the start() warm probe)
        assert srv.health() is not None

    def test_one_bad_batch_does_not_kill_the_worker(self, serving_env):
        srv = self._server()
        sid = srv.attach_stream()
        with srv:
            bad = srv.submit(99, np.ones(4, dtype=np.float32), np.ones(4, dtype=np.float32))
            with pytest.raises(Exception):
                bad.result(timeout=30.0)
            good = srv.submit(sid, np.ones(4, dtype=np.float32), np.ones(4, dtype=np.float32))
            assert good.result(timeout=30.0) == "acked"
            assert float(srv.compute(sid)) == pytest.approx(0.0)

    def test_submit_rejected_when_not_running(self, serving_env):
        srv = self._server()
        with pytest.raises(ServerClosedError):
            srv.submit(0, np.ones(4, dtype=np.float32))
        srv.close()
        with pytest.raises(ServerClosedError):
            srv.compute(0)

    def test_backpressure_full_queue_end_to_end(self, serving_env):
        """A slow device + tiny queue rejects synchronously with an honest
        retry hint; honoring it eventually lands every row (no losses)."""
        srv = self._server(queue_capacity=4)
        sid = srv.attach_stream()
        srv.warm(np.ones(4, dtype=np.float32), np.ones(4, dtype=np.float32))
        with srv:
            srv.set_step_delay(0.05)
            acked, rejections = [], 0
            deadline = time.monotonic() + 60.0
            while len(acked) < 12 and time.monotonic() < deadline:
                try:
                    acked.append(srv.submit(sid, np.ones(4, dtype=np.float32), np.ones(4, dtype=np.float32)))
                except BackpressureError as err:
                    rejections += 1
                    assert err.kind in ("full", "shed")
                    assert 0.0 < err.retry_after_s <= 5.0
                    time.sleep(min(err.retry_after_s, 0.2))
            srv.set_step_delay(0.0)
            assert len(acked) == 12
            assert rejections > 0, "queue of 4 at 20 rows/s must push back"
            for ack in acked:
                assert ack.result(timeout=30.0) == "acked"
        assert srv.rows_applied >= 12

    def test_quarantine_flag_rides_the_ack(self, serving_env):
        srv = self._server()
        sid = srv.attach_stream()
        with srv:
            poisoned = np.ones(4, dtype=np.float32)
            poisoned[0] = np.nan
            bad = srv.submit(sid, poisoned, np.ones(4, dtype=np.float32))
            assert bad.result(timeout=30.0) == "acked"
            assert bad.quarantined
            good = srv.submit(sid, np.ones(4, dtype=np.float32), np.ones(4, dtype=np.float32))
            assert good.result(timeout=30.0) == "acked"
            assert not good.quarantined
            assert float(srv.compute(sid)) == pytest.approx(0.0)

    def test_stop_drains_accepted_requests(self, serving_env):
        srv = self._server()
        sid = srv.attach_stream()
        srv.start()
        acks = [
            srv.submit(sid, np.full(4, i, dtype=np.float32), np.zeros(4, dtype=np.float32))
            for i in range(6)
        ]
        srv.stop(drain=True)
        assert all(a.acked for a in acks), [a.state for a in acks]
        assert not srv.running and _ingest_threads() == []
        srv.close()


_WARM_BOOT_CHILD = r"""
import json
import numpy as np
import torchmetrics_tpu_torch as tt
from torchmetrics_tpu_torch._serving import ControllerConfig, MetricServer

rng = np.random.default_rng(0)
srv = MetricServer(
    tt.MeanSquaredError(device="cpu"), capacity=4,
    controller=ControllerConfig(max_batch=8, interval_s=0.05),
)
sid = srv.attach_stream()
ex = rng.normal(size=(256,)).astype(np.float32)
srv.warm(ex, ex)
srv.start()

def one():
    p = rng.normal(size=(256,)).astype(np.float32)
    t = rng.normal(size=(256,)).astype(np.float32)
    ack = srv.submit(sid, p, t)
    assert ack.result(timeout=60) == "acked"
    return ack.latency_s * 1000.0

first_ms = one()
steady = sorted(one() for _ in range(200))
srv.close()
p99 = steady[min(len(steady) - 1, int(round(0.99 * (len(steady) - 1))))]
print(json.dumps({"first_ms": first_ms, "steady_p99_ms": p99}))
"""


@pytest.mark.slow
def test_warm_boot_first_request_within_budget():
    """In a FRESH process, warm() + the start() worker probe make the very
    first client request cost no more than 1.2x the steady-state p99."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ratios = []
    for _ in range(3):
        res = subprocess.run(
            [sys.executable, "-c", _WARM_BOOT_CHILD],
            capture_output=True,
            text=True,
            env={**os.environ, "PYTHONPATH": root},
            timeout=600,
        )
        assert res.returncode == 0, res.stderr[-2000:]
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        ratios.append(rec["first_ms"] / max(rec["steady_p99_ms"], 1e-9))
    ratios.sort()
    assert ratios[len(ratios) // 2] <= 1.2, ratios


# ------------------------------------------------------------------ parity with the JAX server
def _requests(seed, n_streams, rounds, size=16):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=size).astype(np.float32), rng.normal(size=size).astype(np.float32))
             for _ in range(n_streams)] for _ in range(rounds)]


def _drive(pkg, schedule, *, threads, poison=()):
    """The same requests through one package's server from ``threads`` client threads; values by stream."""
    import importlib

    tm = importlib.import_module(pkg)
    serving = importlib.import_module(pkg + "._serving")
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    srv = serving.MetricServer(tm.MeanSquaredError(nan_policy="quarantine", **kw), capacity=8, queue_capacity=256,
                               controller=serving.ControllerConfig(max_batch=8, interval_s=0.01))
    sids = [srv.attach_stream() for _ in range(len(schedule[0]))]
    srv.warm(*schedule[0][0])
    acks = {sid: [] for sid in sids}

    def client(owned):
        for r, row in enumerate(schedule):
            for lane in owned:
                p, t = row[lane]
                if (r, lane) in poison:
                    p = p.copy()
                    p[0] = np.nan
                acks[sids[lane]].append(srv.submit(sids[lane], p, t))

    with srv:
        workers = [threading.Thread(target=client, args=(range(k, len(sids), threads),)) for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for per in acks.values():
            for a in per:
                assert a.result(timeout=60.0) == "acked"
        values = {sid: float(srv.compute(sid)) for sid in sids}
    quarantined = {sid: [a.quarantined for a in per] for sid, per in acks.items()}
    return values, quarantined


def test_concurrent_ingest_equals_the_jax_server_and_eager_replicas(serving_env):
    """Golden equality: 4 client threads, 6 tenants, 12 rounds, two poisoned rows; the port's server, the JAX
    package's server on the same requests, and eager replicas of each tenant's non-quarantined rows agree."""
    schedule = _requests(5, n_streams=6, rounds=12)
    poison = {(3, 1), (7, 4)}
    got, got_q = _drive("torchmetrics_tpu_torch", schedule, threads=4, poison=poison)
    want, want_q = _drive("torchmetrics_tpu", schedule, threads=4, poison=poison)
    assert got_q == want_q
    assert sum(map(sum, got_q.values())) == 2
    for lane, sid in enumerate(sorted(got)):
        eager = _mse()
        for r, row in enumerate(schedule):
            if (r, lane) not in poison:
                eager.update(*map(torch.from_numpy, row[lane]))
        assert got[sid] == pytest.approx(want[sid], rel=RTOL)
        assert got[sid] == pytest.approx(float(eager.compute()), rel=RTOL)


def _scripted(pkg):
    """One deterministic run (one request in flight at a time) with telemetry on; its counters by metric."""
    import importlib

    tm = importlib.import_module(pkg)
    obs = importlib.import_module(pkg + "._observability")
    serving = importlib.import_module(pkg + "._serving")
    obs.set_telemetry_enabled(True)
    obs.set_telemetry_sampling(1)
    obs.REGISTRY.reset()
    try:
        kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
        srv = serving.MetricServer(tm.MeanSquaredError(nan_policy="quarantine", **kw), capacity=8, queue_capacity=2,
                                   controller=serving.ControllerConfig(max_batch=4, interval_s=3600.0))
        rng = np.random.default_rng(0)
        sids = [srv.attach_stream() for _ in range(3)]
        srv.warm(rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32))
        with srv:
            for k in range(7):
                p = rng.normal(size=8).astype(np.float32)
                if k == 2:
                    p[0] = np.nan
                srv.submit(sids[k % 3], p, rng.normal(size=8).astype(np.float32)).result(30)
            # a shed episode while one slow micro-batch holds the worker: the canary is admitted into the empty
            # queue, and the next arrival, with the canary still queued, is shed
            srv.set_step_delay(1.0)
            slow = srv.submit(sids[0], p, p)
            deadline = time.monotonic() + 30.0
            while srv.queue.depth and time.monotonic() < deadline:
                time.sleep(0.001)
            srv.queue.set_shedding(True)
            canary = srv.submit(sids[1], p, p)
            with pytest.raises(serving.BackpressureError, match="load shedding"):
                srv.submit(sids[2], p, p)
            srv.queue.set_shedding(False)
            srv.set_step_delay(0.0)
            assert slow.result(30) == canary.result(30) == "acked"
            for sid in sids:
                srv.compute(sid)
            srv.compute_all()
        counters = {
            name: {k: v for k, v in rep["counters"].items()
                   if not k.startswith(("latency_", "trace")) and not (name == "StreamPool" and k.startswith("pool_computes"))}
            for name, rep in obs.REGISTRY.to_json()["metrics"].items()
        }
        return counters
    finally:
        obs.set_telemetry_enabled(False)
        obs.REGISTRY.reset()
        obs.BUS.clear()


def test_telemetry_counters_match_the_jax_server_key_for_key(serving_env):
    """The counters of one scripted run (requests accepted, shed and served, batches, rows, pool attach/detach,
    per-stream updates, quarantines, step compiles) are the JAX server's, key for key and value for value.
    Latency buckets are timings; the port's pool also times its step builds (``trace``), a stream-pool divergence;
    ``pool_computes`` differ because the JAX ``compute_all`` bypasses the port's per-stream value cache."""
    got, want = _scripted("torchmetrics_tpu_torch"), _scripted("torchmetrics_tpu")
    serving = {k: v for k, v in want["MetricServer"].items() if k.startswith("serving_")}
    assert serving["serving_requests|outcome=shed"] == 1 and serving["serving_requests|outcome=accepted"] == 9
    assert serving["serving_batches"] == 10  # 9 requests and the start() probe, one a micro-batch
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# ------------------------------------------------------------------ divergences by design (ROADMAP §C)
def test_a_server_built_under_the_sanitizer_takes_sanlocks_and_serves_clean(serving_env):
    """Built with the lock sanitizer armed, the server's pool lock, its queue's and its controller's are
    ``SanLock``s, and a served stream holds their declared discipline; built without it, they are plain locks."""
    from torchmetrics_tpu_torch._analysis import locksan

    plain = MetricServer(_mse(), capacity=2)
    lock_type = type(threading.Lock())
    assert isinstance(plain._pool_lock, lock_type)
    assert isinstance(plain.queue._lock, lock_type) and isinstance(plain.controller._lock, lock_type)
    plain.close()
    locksan.set_locksan_enabled(True)
    locksan.reset()
    try:
        srv = MetricServer(_mse(), capacity=4, controller=ControllerConfig(max_batch=4))
        assert isinstance(srv._pool_lock, locksan.SanLock)
        assert isinstance(srv.queue._lock, locksan.SanLock) and isinstance(srv.controller._lock, locksan.SanLock)
        sid = srv.attach_stream()
        with srv:
            acks = [srv.submit(sid, np.full(4, 2.0, dtype=np.float32), np.zeros(4, dtype=np.float32)) for _ in range(8)]
            assert [a.result(timeout=30.0) for a in acks] == ["acked"] * 8
            assert float(srv.compute(sid)) == 4.0
        assert locksan.violations() == [], locksan.violations()
    finally:
        locksan.set_locksan_enabled(False)
        locksan.reset()


def test_warm_answers_compiled_then_ready_never_hit(serving_env):
    srv = MetricServer(_mse(), capacity=4, controller=ControllerConfig(max_batch=4))
    sid = srv.attach_stream()
    ex = np.arange(4, dtype=np.float32)
    first = srv.warm(ex, ex)
    assert sorted(first) == sorted(f"{b}:{k}" for b in (1, 2, 4)
                                   for k in ("stream_step", "stream_compute_one", "stream_compute_all"))
    assert {k: v for k, v in first.items() if k.endswith("stream_step")} == {f"{b}:stream_step": "compiled" for b in (1, 2, 4)}
    again = srv.warm(ex, ex)
    assert set(again.values()) == {"ready"}
    # the all-masked runs left every stream as it was: the rows landed in the scratch slot
    assert srv.pool.stream_update_count(sid) == 0 and srv.pool.total_row_updates == 0
    assert float(srv.pool._states[""]["sum_squared_error"][sid]) == 0.0
    srv.close()


def test_an_ack_waits_for_no_device_synchronization(serving_env, monkeypatch):
    """An ack resolves once the step is enqueued (on the card: the replay on the pool's stream); the ack path never
    synchronizes the card, and a later ``compute`` sees the acked rows."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: synced.append(1))
    srv = MetricServer(_mse(), capacity=4, controller=ControllerConfig(max_batch=4))
    sid = srv.attach_stream()
    with srv:
        ack = srv.submit(sid, np.full(4, 2.0, dtype=np.float32), np.zeros(4, dtype=np.float32))
        assert ack.result(timeout=30.0) == "acked"
        assert float(srv.compute(sid)) == 4.0
    assert synced == []


def test_the_worker_runs_under_the_pools_device(serving_env):
    srv = MetricServer(_mse(), capacity=2)
    scope = srv._on_pool_device()
    assert not isinstance(scope, torch.cuda.device)  # a CPU pool: no card to make current
    srv.pool.device = torch.device("cuda", 3)  # what the worker would make current for a pool on card 3
    scope = srv._on_pool_device()
    assert isinstance(scope, torch.cuda.device) and scope.idx == 3
    srv.pool.device = torch.device("cpu")
    srv.close()


def test_tensors_go_to_the_host_before_stacking(serving_env):
    """numpy arrays, lists and tensors stack together (a tensor's signature is read without a copy, by numpy's dtype
    names); tensors are copied to the host inside the worker, before it takes the pool lock."""
    req = UpdateRequest(0, (torch.ones(4), np.ones(4, dtype=np.float32)), {"w": torch.zeros(2, dtype=torch.int64)})
    twin = UpdateRequest(1, (np.ones(4, dtype=np.float32), torch.ones(4)), {"w": np.zeros(2, dtype=np.int64)})
    assert port_runtime._signature_of(req) == port_runtime._signature_of(twin)
    assert port_runtime._signature_of(req) == ((((4,), "float32"), ((4,), "float32")), (("w", (2,), "int64"),))
    copies = []
    host = port_runtime._host

    def recording_host(a):
        copies.append((type(a).__name__, srv._pool_lock.locked()))
        return host(a)

    port_runtime._host = recording_host
    try:
        srv = MetricServer(_mse(), capacity=4, controller=ControllerConfig(max_batch=4))
        sids = [srv.attach_stream() for _ in range(3)]
        with srv:
            acks = [srv.submit(sids[0], torch.full((4,), 3.0), torch.zeros(4)),
                    srv.submit(sids[1], np.full(4, 3.0, dtype=np.float32), [0.0, 0.0, 0.0, 0.0]),
                    srv.submit(sids[2], [3.0, 3.0, 3.0, 3.0], np.zeros(4, dtype=np.float32))]
            assert [a.result(timeout=30.0) for a in acks] == ["acked"] * 3
            assert [float(srv.compute(s)) for s in sids] == [9.0, 9.0, 9.0]
    finally:
        port_runtime._host = host
    assert ("Tensor", False) in copies and not any(locked for _, locked in copies)
