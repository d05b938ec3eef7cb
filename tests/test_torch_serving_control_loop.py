"""The port's SLO control loop against the JAX package's (``tests/unittests/serving/test_serving_control_loop.py``).

The first three tests are the JAX suite's, on CPU metrics, with its
schedules: an injected latency fault trips shrink and shed and the loop
re-admits on its own; headroom with a backlog grows the micro-batch target
and beats a pinned minimum batch; a shed episode freezes exactly one
``load_shed`` flight dump. ``test_decisions_match_the_jax_controller`` feeds
the same latency samples to both packages' controllers and holds the
decision sequence (action, target, shed flag) equal and the burn rates to
1e-12 relative (the same float64 arithmetic on the same samples).

The fixture arms telemetry as the JAX one does; the port has no lock
sanitizer, so it asserts after each test that no ingest worker is alive.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import torchmetrics_tpu_torch as tt
from torchmetrics_tpu_torch._observability import (
    BUS,
    REGISTRY,
    arm_flight_recorder,
    disarm_flight_recorder,
    set_telemetry_enabled,
    set_telemetry_sampling,
)
from torchmetrics_tpu_torch._observability.slo import FAST_BURN
from torchmetrics_tpu_torch._observability.state import DEFAULT_SAMPLE_EVERY
from torchmetrics_tpu_torch._serving import BackpressureError, ControllerConfig, MetricServer


@pytest.fixture()
def serving_env():
    set_telemetry_enabled(True)
    set_telemetry_sampling(1)
    yield
    try:
        assert not [t for t in threading.enumerate() if t.name == "tm-serving-ingest" and t.is_alive()]
    finally:
        set_telemetry_enabled(False)
        set_telemetry_sampling(DEFAULT_SAMPLE_EVERY)
        REGISTRY.reset()
        BUS.clear()


def _row(rng):
    return (
        rng.normal(size=(8,)).astype(np.float32),
        rng.normal(size=(8,)).astype(np.float32),
    )


def _mse():
    return tt.MeanSquaredError(device="cpu")


def _submit_with_retry(srv, sid, rng, deadline):
    """One client iteration: honor backpressure, return the ack or None."""
    while time.monotonic() < deadline:
        try:
            return srv.submit(sid, *_row(rng))
        except BackpressureError as err:
            time.sleep(min(err.retry_after_s, 0.005))
    return None


def test_closed_loop_burn_shed_and_autonomous_recovery(serving_env):
    """Injected burn -> shrink+shed -> fault ends -> burn < 1.0, re-admit; nothing touches the controller or the
    queue between the fault's injection and the final assertion."""
    rng = np.random.default_rng(7)
    cfg = ControllerConfig(min_batch=1, max_batch=8, interval_s=0.01, target_ms=5.0, objective=0.95)
    srv = MetricServer(_mse(), capacity=4, queue_capacity=32, controller=cfg)
    sid = srv.attach_stream()
    srv.warm(*_row(rng))
    with srv:
        srv.set_step_delay(0.03)
        deadline = time.monotonic() + 60.0
        while not srv.controller.shedding and time.monotonic() < deadline:
            ack = _submit_with_retry(srv, sid, rng, deadline)
            if ack is not None:
                ack.wait(timeout=30.0)
        assert srv.controller.shedding, "burn never tripped the shed law"
        actions = [d.action for d in srv.controller.decisions()]
        assert "shed" in actions
        shed_decisions = [d for d in srv.controller.decisions() if d.action == "shed"]
        assert shed_decisions[0].burn > FAST_BURN
        assert srv.controller.target == cfg.min_batch

        srv.set_step_delay(0.0)
        while (srv.controller.shedding or srv.controller.burn_rate() >= 1.0) and time.monotonic() < deadline:
            ack = _submit_with_retry(srv, sid, rng, deadline)
            if ack is not None:
                ack.wait(timeout=30.0)
        assert not srv.controller.shedding, "loop never re-admitted"
        assert srv.controller.burn_rate() < 1.0
        actions = [d.action for d in srv.controller.decisions()]
        assert actions.index("shed") < len(actions) - 1 - actions[::-1].index("hold")
        assert BUS.events(kind="controller_decision"), "decisions must hit the bus"
        assert BUS.events(kind="load_shed") and BUS.events(kind="load_shed_recovered")
    assert srv.queue.shed_episodes >= 1


def test_headroom_grows_target_and_beats_fixed_batching(serving_env):
    """A backlog with latency headroom grows the target; adaptive sizing sustains more rows/second than a pinned
    minimum batch under the same per-dispatch overhead."""
    rounds, n_streams, overhead_s = 12, 8, 0.005

    def drive(max_batch):
        rng = np.random.default_rng(11)
        cfg = ControllerConfig(min_batch=1, max_batch=max_batch, interval_s=0.005, target_ms=2000.0, objective=0.95)
        srv = MetricServer(_mse(), capacity=n_streams, queue_capacity=256, controller=cfg)
        sids = [srv.attach_stream() for _ in range(n_streams)]
        srv.warm(*_row(rng))
        with srv:
            srv.set_step_delay(overhead_s)
            t0 = time.perf_counter()
            acks = []
            for _ in range(rounds):
                for sid in sids:
                    acks.append(srv.submit(sid, *_row(rng)))
            for ack in acks:
                assert ack.result(timeout=60.0) == "acked"
            elapsed = time.perf_counter() - t0
            decisions = srv.controller.decisions()
            target = srv.controller.target
        qps = len(acks) / elapsed
        REGISTRY.reset()  # isolate the two runs' burn signals
        return qps, decisions, target, srv.batches

    adaptive_qps, decisions, target, adaptive_batches = drive(max_batch=8)
    fixed_qps, _, fixed_target, fixed_batches = drive(max_batch=1)

    assert any(d.action == "grow" for d in decisions), [d.action for d in decisions]
    assert target > 1, "headroom + backlog must raise the target"
    assert fixed_target == 1
    assert adaptive_batches < fixed_batches
    assert adaptive_qps > fixed_qps, (adaptive_qps, fixed_qps)


def test_shed_episode_freezes_exactly_one_flight_dump(serving_env, tmp_path):
    """Load shedding is a flight-recorder trigger: entering an episode dumps once (seam serving.ingress); the
    recovery transition does not dump."""
    rng = np.random.default_rng(3)
    recorder = arm_flight_recorder(directory=str(tmp_path), keep=64)
    try:
        cfg = ControllerConfig(min_batch=1, max_batch=4, interval_s=0.01, target_ms=5.0, objective=0.95)
        srv = MetricServer(_mse(), capacity=2, queue_capacity=16, controller=cfg)
        sid = srv.attach_stream()
        srv.warm(*_row(rng))
        with srv:
            srv.set_step_delay(0.03)
            deadline = time.monotonic() + 60.0
            while not srv.controller.shedding and time.monotonic() < deadline:
                ack = _submit_with_retry(srv, sid, rng, deadline)
                if ack is not None:
                    ack.wait(timeout=30.0)
            assert srv.controller.shedding
            srv.set_step_delay(0.0)
            while srv.controller.shedding and time.monotonic() < deadline:
                ack = _submit_with_retry(srv, sid, rng, deadline)
                if ack is not None:
                    ack.wait(timeout=30.0)
        episodes = srv.queue.shed_episodes
        assert episodes >= 1
        dumps = [d for d in recorder.dumps() if d["trigger"]["kind"] == "load_shed"]
        assert len(dumps) == episodes, "exactly one dump per shed episode"
        for dump in dumps:
            assert dump["seam"] == "serving.ingress"
            assert dump["trigger"]["data"]["phase"] == "enter"
        seqs = [d["trigger"]["seq"] for d in dumps]
        assert len(seqs) == len(set(seqs))
    finally:
        disarm_flight_recorder()


# the latency samples (seconds) one evaluation sees, then the queue depth it is offered: headroom with a backlog
# (grow, grow), no backlog (hold), a burn between OK_BURN and 1 (hold), past FAST_BURN (shed), between 1 and
# FAST_BURN (shrink, the shed kept), then recovery (grow, grow, hold)
_SCHEDULE = (
    ([0.001] * 20, 16), ([0.001] * 20, 16), ([0.001] * 20, 2), ([0.02] * 3 + [0.001] * 17, 16),
    ([0.02] * 128, 16), ([0.02] * 64 + [0.001] * 64, 16), ([0.001] * 128, 16), ([0.001] * 128, 16),
    ([0.001] * 128, 0),
)


def _decisions(pkg):
    import importlib

    obs = importlib.import_module(pkg + "._observability")
    serving = importlib.import_module(pkg + "._serving")
    telemetry = importlib.import_module(pkg + "._observability.telemetry")
    obs.set_telemetry_enabled(True)
    obs.set_telemetry_sampling(1)
    obs.REGISTRY.reset()
    try:
        ctl = serving.BatchController(serving.ControllerConfig(min_batch=1, max_batch=16, grow_step=4, interval_s=0.0,
                                                               target_ms=5.0, objective=0.95))

        class Source:  # the server's telemetry owner: the controller reads the `ingest` op of the registry
            pass

        src = Source()
        out = []
        for samples, depth in _SCHEDULE:
            for s in samples:
                telemetry.telemetry_for(src).observe("ingest", s)
            d = ctl.maybe_decide(depth)
            out.append((d.action, d.target, d.previous, d.shed, d.queue_depth, d.burn))
        return out, [e.data["action"] for e in obs.BUS.events(kind="controller_decision")]
    finally:
        obs.set_telemetry_enabled(False)
        obs.REGISTRY.reset()
        obs.BUS.clear()


def test_decisions_match_the_jax_controller(serving_env):
    got, got_bus = _decisions("torchmetrics_tpu_torch")
    want, want_bus = _decisions("torchmetrics_tpu")
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        assert g[5] == pytest.approx(w[5], rel=1e-12, abs=0.0)
    assert got_bus == want_bus
    actions = [w[0] for w in want]
    assert {"grow", "shrink", "shed", "hold"} <= set(actions), actions
