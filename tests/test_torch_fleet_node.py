"""The port's ``AggregationNode`` on one parent/child pair (``tests/unittests/fleet/test_node.py``).

Each JAX test's call sequence runs through both packages (the port's metrics
on ``device="cpu"``); the port must show what the JAX test asserts, and the
same receipts (contributing, missing, sources, counts) and values as the JAX
package, at rtol 1e-5 / atol 1e-6.

Added for the port: the divergence by design of its send thread. An
asynchronous publish whose retries are exhausted runs no tensor operation on
its thread (a recording ``TorchDispatchMode`` and ``TorchFunctionMode`` on
that thread see none, with telemetry and the flight recorder armed), hands
back bytes only, and its delta folds at the next epoch. And a template that
has compiled its update clones into nodes with no compiled step of their own.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_fleet_transport import JAX, PORT, SIDES, value
from torchmetrics_tpu._observability.state import OBS as J_OBS
from torchmetrics_tpu._observability.state import set_telemetry_enabled as j_set_telemetry
from torchmetrics_tpu_torch._observability.flight import arm_flight_recorder, disarm_flight_recorder
from torchmetrics_tpu_torch._observability.state import OBS as T_OBS
from torchmetrics_tpu_torch._observability.state import set_telemetry_enabled as t_set_telemetry
from torchmetrics_tpu_torch._observability.telemetry import REGISTRY as T_REGISTRY
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as t_telemetry_for

RTOL, ATOL = 1e-5, 1e-6


def _retry(S):
    return S.Retry(max_retries=2, backoff_base=0.005, backoff_max=0.02)


def _pair(S, template=None, deadline_s=0.5, epoch_window=4):
    template = template if template is not None else S.agg.MeanMetric(**S.kw)
    kv = S.fleet.InProcessKV()
    leaf = S.fleet.AggregationNode("edge-00", template, kv, namespace="t", retry=_retry(S))
    parent = S.fleet.AggregationNode(
        "region-00", template, kv, children=("edge-00",), namespace="t",
        deadline_s=deadline_s, retry=_retry(S), epoch_window=epoch_window,
    )
    return kv, leaf, parent


def receipt(r):
    return (r.node_id, r.epoch, r.contributing, r.missing, r.sources, r.partial, r.late_arrivals,
            r.duplicates_dropped, r.corrupt_quarantined, r.rows_folded)


def _same(run):
    """``run(S)`` on both packages: ``(receipts, values)``; equal receipts, values at the JAX tolerances."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (jr, jv), (pr, pv) = run(JAX), run(PORT)
    assert pr == jr
    for a, b in zip(pv, jv):
        np.testing.assert_allclose(value(a), value(b), rtol=RTOL, atol=ATOL)
    return pr, pv


class TestFold:
    def test_leaf_publish_parent_fold_golden(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(2.0)
            leaf.update(4.0)
            ok = leaf.publish(0)
            r = parent.rollup(0)
            return (ok, receipt(r), parent.folded_sources, kv.scan("")), [parent.metric.compute()]

        (ok, r, folded, left), (val,) = _same(run)
        assert ok and not r[5] and r[2] == (("edge-00", 0),)
        assert r[4] == (("edge-00", 0),) and r[9] == 2
        assert folded == {("edge-00", 0)}
        assert float(val) == pytest.approx(3.0)
        assert left == {}  # folded keys are reaped from the transport

    def test_delta_semantics_each_row_folds_once(self):
        def run(S):
            kv, leaf, parent = _pair(S, S.agg.SumMetric(**S.kw))
            leaf.update(S.arr(np.float32(1.0)))
            oks = [leaf.publish(0)]
            parent.rollup(0)
            leaf.update(S.arr(np.float32(10.0)))
            oks.append(leaf.publish(1))  # ships ONLY the new delta
            parent.rollup(1)
            return oks, [parent.metric.compute()]

        oks, (val,) = _same(run)
        assert oks == [True, True] and float(val) == pytest.approx(11.0)

    def test_zero_count_heartbeat_counts_for_fanin_not_provenance(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            ok = leaf.publish(0)  # idle edge: no rows this epoch
            r = parent.rollup(0)
            return (ok, receipt(r), parent.folded_sources, parent.metric._update_count), []

        (ok, r, folded, count), _ = _same(run)
        assert ok and not r[5] and r[2] == (("edge-00", 0),)
        assert r[4] == () and folded == set() and count == 0

    def test_mean_weighting_survives_hierarchy(self):
        # an idle epoch between data epochs must not skew the weighted mean
        def run(S):
            kv, leaf, parent = _pair(S)
            for _ in range(3):
                leaf.update(1.0)
            oks = [leaf.publish(0)]
            parent.rollup(0)
            oks.append(leaf.publish(1))  # zero-count heartbeat
            parent.rollup(1)
            leaf.update(5.0)
            oks.append(leaf.publish(2))
            parent.rollup(2)
            return oks, [parent.metric.compute()]

        oks, (val,) = _same(run)
        assert all(oks) and float(val) == pytest.approx(2.0)  # (1+1+1+5)/4


class TestFence:
    def test_duplicate_redelivery_dropped(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(1.0)
            assert leaf.publish(0)
            key, blob = next(iter(kv.scan("").items()))
            parent.rollup(0)
            kv.set(key, blob)  # at-least-once redelivery of the folded payload
            r = parent.rollup(1)
            return receipt(r), [parent.metric.compute()]

        r, (val,) = _same(run)
        assert r[7] == 1 and r[2] == ()
        assert float(val) == pytest.approx(1.0)  # no double fold

    def test_zombie_below_watermark_never_swept(self):
        def run(S):
            kv, leaf, parent = _pair(S, epoch_window=2)
            leaf.update(1.0)
            assert leaf.publish(0)
            key, blob = next(iter(kv.scan("").items()))
            parent.rollup(0)
            for e in range(1, 5):
                assert leaf.publish(e)
                parent.rollup(e)
            kv.set(key, blob)  # zombie from epoch 0, watermark is now 2
            r = parent.rollup(5)
            # the orphan is the TTL janitor's to reap
            reaped = key in kv.sweep_expired(now=time.monotonic() + 10_000.0)
            return (receipt(r), reaped), [parent.metric.compute()]

        (r, reaped), (val,) = _same(run)
        assert r[7] == 0  # below the window: not even scanned
        assert float(val) == pytest.approx(1.0) and reaped

    def test_late_arrival_folds_into_next_epoch(self):
        def run(S):
            kv, leaf, parent = _pair(S, deadline_s=0.05)
            r0 = parent.rollup(0)  # leaf has not published: deadline degrades
            leaf.update(7.0)
            assert leaf.publish(0)  # the straggler lands late
            r1 = parent.rollup(1)
            return (receipt(r0), receipt(r1)), [parent.metric.compute()]

        (r0, r1), (val,) = _same(run)
        assert r0[5] and r0[3] == ("edge-00",)
        assert r1[6] == 1 and ("edge-00", 0) in r1[2]
        assert float(val) == pytest.approx(7.0)

    def test_partial_rollup_records_degradation_with_missing_set(self):
        def run(S):
            kv, leaf, parent = _pair(S, deadline_s=0.05)
            r = parent.rollup(0)
            events = [e for e in parent.metric.resilience_report().events if e.kind == "fleet_partial"]
            return (receipt(r), len(events), "edge-00" in events[0].detail), []

        (r, n_events, named), _ = _same(run)
        assert r[5] and r[3] == ("edge-00",) and n_events == 1 and named


class TestQuarantine:
    def test_bit_flipped_payload_quarantined(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(3.0)
            assert leaf.publish(0)
            key, blob = next(iter(kv.scan("").items()))
            flipped = bytearray(blob)
            flipped[-1] ^= 0xFF
            kv.set(key, bytes(flipped))
            r = parent.rollup(0)
            events = [e for e in parent.metric.resilience_report().events if e.kind == "fleet_corrupt"]
            return (receipt(r), parent.metric._update_count, len(events), kv.get(key)), []

        (r, count, n_events, left), _ = _same(run)
        assert r[8] == 1 and r[5]  # nothing usable folded
        assert count == 0 and n_events == 1
        assert left is None  # quarantined keys are deleted, not retried

    def test_key_payload_fence_mismatch_quarantined(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            m = S.agg.MeanMetric(**S.kw)
            m.update(1.0)
            blob, digest = S.fleet.encode_contribution(m, "edge-00", 3, (("edge-00", 3),))
            # a zombie stamping its old payload under a fresh epoch's key
            kv.set(S.fleet.contribution_key("t", "edge-00", 0, digest), blob)
            return receipt(parent.rollup(0)), []

        r, _ = _same(run)
        assert r[8] == 1

    def test_wrong_metric_class_quarantined(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            other = S.agg.SumMetric(**S.kw)
            other.update(S.arr(np.float32(5.0)))
            blob, digest = S.fleet.encode_contribution(other, "edge-00", 0, ())
            kv.set(S.fleet.contribution_key("t", "edge-00", 0, digest), blob)
            r = parent.rollup(0)
            return (receipt(r), parent.metric._update_count), []

        (r, count), _ = _same(run)
        assert r[8] == 1 and count == 0


class TestPublishGuard:
    def test_transient_fault_absorbed_by_retry(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(1.0)
            kv.fail_publishes(1)
            ok = leaf.publish(0)  # one fault, retry lands it
            return (ok, receipt(parent.rollup(0)), leaf.publish_failures), []

        (ok, r, failures), _ = _same(run)
        assert ok and not r[5] and failures == 0

    def test_exhausted_retries_degrade_and_retain_delta(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(2.0)
            kv.fail_publishes(_retry(S).attempts)
            ok0 = leaf.publish(0)  # all attempts consumed
            events = [e for e in leaf.metric.resilience_report().events if e.kind == "fleet_publish_degraded"]
            # the delta rides the next epoch's publish: nothing lost
            leaf.update(4.0)
            ok1 = leaf.publish(1)
            r = parent.rollup(1)
            return (ok0, ok1, leaf.publish_failures, len(events), events[0].attempts, receipt(r)), [
                parent.metric.compute()]

        (ok0, ok1, failures, n_events, attempts, r), (val,) = _same(run)
        assert not ok0 and ok1 and failures == 1
        assert n_events == 1 and attempts == _retry(PORT).attempts
        assert set(r[4]) == {("edge-00", 0), ("edge-00", 1)}
        assert float(val) == pytest.approx(3.0)

    def test_async_publish_threads_are_joinable(self):
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(1.0)
            t = leaf.publish_async(0)
            leaf.join_pending(timeout=5.0)
            return (t.is_alive(), t.name, receipt(parent.rollup(0))), []

        (alive, name, r), _ = _same(run)
        assert not alive and name == "fleet-publish-edge-00-0" and not r[5]


class TestTelemetry:
    def _on(self):
        was = (J_OBS.enabled, T_OBS.enabled)
        j_set_telemetry(True)
        t_set_telemetry(True)
        return was

    def _restore(self, was):
        j_set_telemetry(was[0])
        t_set_telemetry(was[1])

    def test_fleet_counters_and_staleness_gauge(self):
        was = self._on()
        try:
            counters = {}
            for S in SIDES:
                kv, leaf, parent = _pair(S)
                leaf.region = parent.region = "region-00"
                leaf.update(1.0)
                assert leaf.publish(0)
                parent.rollup(0)
                counters[S.name] = {k: v for k, v in dict(parent.metric.telemetry_report().counters).items()
                                    if k.startswith("fleet_")}
            got = counters["port"]
            assert got.get("fleet_rollups|region=region-00|outcome=full") == 1
            assert got.get("fleet_contributions|region=region-00") == 1
            assert got == counters["jax"]
            gauges = dict(t_telemetry_for(parent.metric).gauges)
            assert "fleet_rollup_staleness_ms|region=region-00" in gauges
        finally:
            self._restore(was)

    def test_rollup_exports_through_schema(self):
        # rendered exposition must stay inside EXPORT_SCHEMA (fleet families
        # are declared with their bounded region label)
        was = self._on()
        try:
            kv, leaf, parent = _pair(PORT)
            leaf.update(1.0)
            assert leaf.publish(0)
            parent.rollup(0)
            text = T_REGISTRY.render_prometheus()
            assert "tmtpu_fleet_rollups_total" in text
            assert 'region="region-00"' in text
        finally:
            self._restore(was)


class _Recorder(TorchDispatchMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


class _FnRecorder(TorchFunctionMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def test_exhausted_async_publish_touches_no_tensor_on_its_thread(tmp_path, monkeypatch):
    """The divergence by design: the send thread gets bytes, runs no tensor op, and hands the bytes back.

    The JAX node merges the outbound delta back on the send thread
    (``torchmetrics_tpu/_fleet/node.py:456-464``); the port's owner thread merges it
    at the next publish, and the fold is the JAX node's.
    """
    from torchmetrics_tpu_torch._fleet import node as t_node

    seen, args_seen = [], []
    inner = t_node.AggregationNode._send

    def recorded_send(self, prepared):
        if threading.current_thread() is threading.main_thread():
            return inner(self, prepared)
        args_seen.append(prepared)
        with _Recorder(seen), _FnRecorder(seen):
            return inner(self, prepared)

    monkeypatch.setattr(t_node.AggregationNode, "_send", recorded_send)
    was = T_OBS.enabled
    t_set_telemetry(True)
    recorder = arm_flight_recorder(str(tmp_path))
    try:
        def run(S):
            kv, leaf, parent = _pair(S)
            leaf.update(2.0)
            leaf.update(6.0)
            kv.fail_publishes(_retry(S).attempts)
            t = leaf.publish_async(0)
            t.join(5.0)
            r0 = parent.rollup(0)  # nothing arrived: partial
            leaf.update(10.0)
            assert leaf.publish(1)  # carries epoch 0's delta too
            r1 = parent.rollup(1)
            leaf.join_pending(5.0)
            return (receipt(r0), receipt(r1), leaf.publish_failures), [parent.metric.compute()]

        (r0, r1, failures), (val,) = _same(run)
    finally:
        disarm_flight_recorder()
        t_set_telemetry(was)
    assert r0[5] and r0[3] == ("edge-00",)
    assert set(r1[4]) == {("edge-00", 0), ("edge-00", 1)} and r1[9] == 3
    assert failures == 1 and float(val) == pytest.approx(6.0)
    # the thread saw bytes, strings and ints only, and ran no tensor operation
    assert len(args_seen) == 1
    key, blob, epoch, sources = args_seen[0]
    assert isinstance(key, str) and isinstance(blob, bytes) and epoch == 0 and sources == {("edge-00", 0)}
    assert seen == []
    # its degradation froze one flight dump, also read on that thread
    kinds = [d["trigger"]["data"].get("kind") for d in recorder.dumps() if d["trigger"]["kind"] == "degradation"]
    assert kinds.count("fleet_publish_degraded") == 1


def test_a_compiled_template_clones_into_nodes_without_its_steps():
    """``clone()`` drops the template's compiled steps and copies its states; the nodes reset."""
    from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
    from torchmetrics_tpu_torch._fleet import FleetTree

    template = MulticlassConfusionMatrix(num_classes=7, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):  # eager, then the compiled step
        template.update(torch.as_tensor(rng.integers(0, 7, 16)), torch.as_tensor(rng.integers(0, 7, 16)))
    assert template.__dict__.get("_auto_update_fn")
    tree = FleetTree.build(template, (1, 2), retry=_retry(PORT))
    for node in tree.nodes.values():
        for m in (node.metric, node._template, node._pending_delta):
            assert not m.__dict__.get("_auto_update_fn") and m._update_count == 0
            assert int(m.confmat.sum()) == 0
            assert m.confmat.data_ptr() != template.confmat.data_ptr()
    assert int(template.confmat.sum()) == 48  # the template is left as it was
