"""The port's fleet KV transport and wire format (``tests/unittests/fleet/test_transport.py``).

Each JAX test's call sequence runs through both packages' ``InProcessKV``,
keys and codec; the port must show what the JAX test asserts, and the same
observations as the JAX package. Added for the port: the keys equal the JAX
package's for the same coordinates, and a decoded contribution holds host
values only (numpy, ``HostBF16``), never a tensor.

The module's ``JAX``/``PORT`` namespaces are shared by the other
``test_torch_fleet_*`` files.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import torchmetrics_tpu._fleet as j_fleet
import torchmetrics_tpu.aggregation as j_agg
import torchmetrics_tpu_torch._fleet as t_fleet
import torchmetrics_tpu_torch.aggregation as t_agg
from torchmetrics_tpu._resilience.policy import RetryPolicy as JRetryPolicy
from torchmetrics_tpu_torch._resilience.integrity import HostBF16
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy as TRetryPolicy

JAX = types.SimpleNamespace(
    name="jax", fleet=j_fleet, agg=j_agg, kw={}, Retry=JRetryPolicy,
    arr=lambda a: np.asarray(a),
)
PORT = types.SimpleNamespace(
    name="port", fleet=t_fleet, agg=t_agg, kw={"device": "cpu"}, Retry=TRetryPolicy,
    arr=lambda a: torch.as_tensor(np.asarray(a)),
)
SIDES = (JAX, PORT)


def value(x):
    """A computed value as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def holds_no_tensor(obj):
    """True when no ``torch.Tensor`` sits anywhere in a (nested) container."""
    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(holds_no_tensor(k) and holds_no_tensor(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return all(holds_no_tensor(v) for v in obj)
    return True


def _both(fn):
    got = {S.name: fn(S) for S in SIDES}
    assert got["port"] == got["jax"], got
    return got["port"]


class TestInProcessKV:
    def test_set_get_scan_delete(self):
        def run(S):
            kv = S.fleet.InProcessKV()
            kv.set("tm_tpu/fleet/ns/contrib/a/0/d1", b"one")
            kv.set("tm_tpu/fleet/ns/contrib/a/1/d2", b"two")
            kv.set("tm_tpu/fleet/ns/contrib/b/0/d3", b"three")
            got = kv.get("tm_tpu/fleet/ns/contrib/a/0/d1"), kv.get("missing")
            snap = sorted(kv.scan("tm_tpu/fleet/ns/contrib/a/").values())
            kv.delete("tm_tpu/fleet/ns/contrib/a/0/d1")
            return got, snap, kv.get("tm_tpu/fleet/ns/contrib/a/0/d1"), kv.keys("tm_tpu/fleet/ns/contrib/*")

        got, snap, deleted, keys = _both(run)
        assert got == (b"one", None) and snap == [b"one", b"two"] and deleted is None
        assert keys == ["tm_tpu/fleet/ns/contrib/a/1/d2", "tm_tpu/fleet/ns/contrib/b/0/d3"]

    def test_wait_until_wakes_on_publish(self):
        for S in SIDES:
            kv = S.fleet.InProcessKV()

            def later():
                time.sleep(0.05)
                kv.set("k/x", b"v")

            t = threading.Thread(target=later)
            t.start()
            try:
                # wakes well before the 5s deadline: notify, not polling
                t0 = time.perf_counter()
                assert kv.wait_until(lambda snap: "k/x" in snap, 5.0), S.name
                assert time.perf_counter() - t0 < 2.0, S.name
            finally:
                t.join()

    def test_wait_until_deadline_is_degrade_not_error(self):
        for S in SIDES:
            kv = S.fleet.InProcessKV()
            t0 = time.perf_counter()
            assert not kv.wait_until(lambda snap: False, 0.05), S.name
            assert time.perf_counter() - t0 >= 0.04, S.name

    def test_fault_injection_arms_next_n_sets(self):
        def run(S):
            kv = S.fleet.InProcessKV()
            kv.fail_publishes(2)
            raised = []
            for _ in range(2):
                with pytest.raises(S.fleet.InjectedKvFault) as err:
                    kv.set("k", b"v")
                raised.append(isinstance(err.value, S.fleet.FleetTransportError))
            kv.set("k", b"v")  # third succeeds
            return raised, kv.get("k"), kv.faults_injected, kv.set_calls

        assert _both(run) == ([True, True], b"v", 2, 3)

    def test_stall_injection_delays_outside_lock(self):
        for S in SIDES:
            kv = S.fleet.InProcessKV()
            kv.stall_publishes(1, 0.15)
            done = []

            def stalled():
                kv.set("slow", b"v")
                done.append("slow")

            t = threading.Thread(target=stalled)
            t.start()
            try:
                time.sleep(0.03)
                # a stalled publisher must not serialize everyone else
                t0 = time.perf_counter()
                kv.set("fast", b"v")
                assert time.perf_counter() - t0 < 0.1, S.name
                assert kv.get("fast") == b"v" and kv.get("slow") is None, S.name
            finally:
                t.join()
            assert done == ["slow"] and kv.get("slow") == b"v", S.name
            assert kv.stalls_injected == 1

    def test_ttl_sweep_reaps_orphans(self):
        def run(S):
            kv = S.fleet.InProcessKV(ttl_s=10.0)
            kv.set("orphan", b"v")
            young = kv.sweep_expired()  # young key survives
            reaped = kv.sweep_expired(now=time.monotonic() + 60.0)
            return young, reaped, kv.get("orphan"), kv.janitor.pending()

        assert _both(run) == ([], ["orphan"], None, 0)


class TestKeys:
    def test_contribution_key_carries_fence_coordinates(self):
        key = t_fleet.contribution_key("prod", "edge-00-01", 7, "abcd1234")
        assert key == "tm_tpu/fleet/prod/contrib/edge-00-01/7/abcd1234"
        assert key.startswith(t_fleet.contribution_prefix("prod", "edge-00-01", 7))
        assert key == j_fleet.contribution_key("prod", "edge-00-01", 7, "abcd1234")

    def test_prefix_does_not_cross_epochs(self):
        # epoch 1's prefix must not match epoch 10's keys
        assert not t_fleet.contribution_key("ns", "a", 10, "d").startswith(t_fleet.contribution_prefix("ns", "a", 1))
        assert t_fleet.contribution_prefix("ns", "a", 1) == j_fleet.contribution_prefix("ns", "a", 1)


class TestWire:
    def _contrib(self, S, value=3.0):
        m = S.agg.MeanMetric(**S.kw)
        m.update(value)
        m.update(2 * value)
        return encode(S, m, "edge-00", 4, (("edge-00", 4),))

    def test_round_trip(self):
        for S in SIDES:
            blob, digest = self._contrib(S)
            c = S.fleet.decode_contribution(blob)
            assert (c.node, c.epoch, c.count) == ("edge-00", 4, 2)
            assert c.metric_class == "MeanMetric"
            assert c.sources == (("edge-00", 4),)
            assert c.digest == digest and len(digest) == 16
            assert c.age_ms >= 0.0
            # the shipped states carry an integrity block (verified at fold)
            assert any(k.endswith("#integrity") for k in c.states)
        # the same states on the wire, block for block
        jc = j_fleet.decode_contribution(self._contrib(JAX)[0])
        pc = t_fleet.decode_contribution(self._contrib(PORT)[0])
        assert sorted(pc.states) == sorted(jc.states)
        assert pc.states["#integrity"] == jc.states["#integrity"]

    def test_checksum_rejects_bit_flip_before_unpickle(self):
        blob, _ = self._contrib(PORT)
        flipped = bytearray(blob)
        flipped[-1] ^= 0xFF
        with pytest.raises(t_fleet.CorruptContribution, match="checksum"):
            t_fleet.decode_contribution(bytes(flipped))

    def test_truncation_and_garbage_rejected(self):
        blob, _ = self._contrib(PORT)
        with pytest.raises(t_fleet.CorruptContribution):
            t_fleet.decode_contribution(blob[: len(blob) // 2])
        with pytest.raises(t_fleet.CorruptContribution):
            t_fleet.decode_contribution(b"not a contribution at all")
        with pytest.raises(t_fleet.CorruptContribution, match="truncated"):
            t_fleet.decode_contribution(t_fleet.wire.WIRE_MAGIC + b"short")

    def test_digest_tracks_state_content(self):
        _, d1 = self._contrib(PORT, 3.0)
        _, d2 = self._contrib(PORT, 4.0)
        assert d1 != d2

    def test_class_name_travels(self):
        for S in SIDES:
            m = S.agg.SumMetric(**S.kw)
            m.update(S.arr(np.float32(1.0)))
            blob, _ = S.fleet.encode_contribution(m, "n", 0, ())
            assert S.fleet.decode_contribution(blob).metric_class == "SumMetric"

    def test_decoded_states_hold_no_tensor(self):
        """Host values only on the wire: numpy for float and integer states, ``HostBF16`` for bfloat16 ones."""
        from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix

        rng = np.random.default_rng(0)
        cm = MulticlassConfusionMatrix(num_classes=5, device="cpu")
        cm.update(torch.as_tensor(rng.integers(0, 5, 16)), torch.as_tensor(rng.integers(0, 5, 16)))
        cat = t_agg.CatMetric(device="cpu")
        cat.update(torch.arange(4.0))
        cat.update(torch.arange(3.0))
        mean = t_agg.MeanMetric(device="cpu")
        mean.update(torch.tensor([1.0, 2.0]))
        mean.set_dtype(torch.bfloat16)
        for m in (cm, cat, mean):
            c = t_fleet.decode_contribution(encode(PORT, m, "n", 0, ())[0])
            assert holds_no_tensor(c.states), (type(m).__name__, c.states)
        assert isinstance(t_fleet.decode_contribution(encode(PORT, mean, "n", 0, ())[0]).states["value"], HostBF16)
        states = t_fleet.decode_contribution(encode(PORT, cm, "n", 0, ())[0]).states
        np.testing.assert_array_equal(states["confmat"], cm.confmat.numpy())


def encode(S, metric, node, epoch, sources):
    return S.fleet.encode_contribution(metric, node, epoch, sources)
