"""The port's ``CoordinationServiceKV`` over ``torch.distributed`` stores.

The JAX class wraps the JAX coordination-service client
(``torchmetrics_tpu/_fleet/transport.py:190``); the port's keeps the name and
the contract over a ``torch.distributed.Store``. Each test runs on a
``HashStore``, a world-1 ``TCPStore`` on 127.0.0.1 and a ``FileStore`` in
``tmp_path``: set/get/scan/delete, an absent key answered at once (the
store's own ``get`` would wait out its timeout), the prefix filter (a
``FileStore`` lists its own ``efcount/`` key), ``wait_until`` with its
deadline, the TTL sweep, the default process group's store, and the raise
when there is neither. A ``(2, 2)`` tree driven over a store must be bit
for bit the same tree over ``InProcessKV``.
"""

import datetime
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torchmetrics_tpu_torch._fleet import CoordinationServiceKV, FleetTree, InProcessKV
from torchmetrics_tpu_torch._resilience.policy import RetryPolicy
from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix

FAST_RETRY = RetryPolicy(max_retries=2, backoff_base=0.005, backoff_max=0.02)
# long enough that a blocking `get` of an absent key would show in the timings below
STORE_TIMEOUT = datetime.timedelta(seconds=30)
NS = "tm_tpu/fleet/ns/contrib/"


@pytest.fixture(params=["hash", "tcp", "file"])
def store(request, tmp_path):
    if request.param == "hash":
        s = dist.HashStore()
        s.set_timeout(STORE_TIMEOUT)
    elif request.param == "tcp":
        s = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=STORE_TIMEOUT, wait_for_workers=False)
    else:
        s = dist.FileStore(str(tmp_path / "fleet_store"), 1)
        s.set_timeout(STORE_TIMEOUT)
    return s


def test_set_get_scan_delete(store):
    kv = CoordinationServiceKV(store=store)
    kv.set(NS + "a/0/d1", b"one")
    kv.set(NS + "a/1/d2", b"two")
    kv.set(NS + "b/0/d3", b"three")
    assert kv.get(NS + "a/0/d1") == b"one"
    assert kv.scan(NS + "a/") == {NS + "a/0/d1": b"one", NS + "a/1/d2": b"two"}
    kv.delete(NS + "a/0/d1")
    assert kv.get(NS + "a/0/d1") is None
    assert kv.scan(NS) == {NS + "a/1/d2": b"two", NS + "b/0/d3": b"three"}
    assert kv.janitor.pending() == 2


def test_absent_key_returns_none_at_once(store):
    kv = CoordinationServiceKV(store=store)
    t0 = time.perf_counter()
    assert kv.get(NS + "never/0/x") is None
    assert kv.scan(NS + "never/") == {}
    assert time.perf_counter() - t0 < 5.0


def test_scan_keeps_only_the_prefix(store):
    kv = CoordinationServiceKV(store=store)
    store.set("unrelated/key", b"x")
    kv.set(NS + "a/0/d", b"v")
    # the store lists its own bookkeeping (FileStore's efcount/) and other tenants' keys
    assert "unrelated/key" in store.list_keys()
    assert kv.scan(NS) == {NS + "a/0/d": b"v"}
    assert kv.scan("tm_tpu/") == {NS + "a/0/d": b"v"}


def test_wait_until_sees_a_late_publish_and_honours_the_deadline(store):
    kv = CoordinationServiceKV(store=store, poll_s=0.01)
    t0 = time.perf_counter()
    assert not kv.wait_until(lambda snap: NS + "a/0/d" in snap, 0.1, prefix=NS)
    assert 0.09 <= time.perf_counter() - t0 < 5.0

    def later():
        time.sleep(0.05)
        kv.set(NS + "a/0/d", b"v")

    t = threading.Thread(target=later)
    t.start()
    try:
        assert kv.wait_until(lambda snap: NS + "a/0/d" in snap, 5.0, prefix=NS)
    finally:
        t.join()
    # without a prefix the predicate sees an empty snapshot, as in the JAX class
    assert not kv.wait_until(lambda snap: bool(snap), 0.02)


def test_ttl_sweep_reaps_orphans(store):
    kv = CoordinationServiceKV(store=store, ttl_s=10.0)
    kv.set(NS + "orphan/0/d", b"v")
    assert kv.sweep_expired() == []
    assert kv.sweep_expired(now=time.monotonic() + 60.0) == [NS + "orphan/0/d"]
    assert kv.get(NS + "orphan/0/d") is None and kv.janitor.pending() == 0


def test_no_store_and_no_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        CoordinationServiceKV()


def test_default_process_group_store():
    assert not dist.is_initialized()
    backing = dist.HashStore()
    dist.init_process_group("gloo", store=backing, rank=0, world_size=1)
    try:
        kv = CoordinationServiceKV()
        kv.set(NS + "a/0/d", b"v")
        assert kv.scan(NS) == {NS + "a/0/d": b"v"}
        kv.delete(NS + "a/0/d")
        assert kv.get(NS + "a/0/d") is None
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def _rows(seed=5, classes=40, leaves=4, epochs=2, n=64):
    rng = np.random.default_rng(seed)
    return {(e, i): [(rng.integers(0, classes, n), rng.integers(0, classes, n)) for _ in range(2)]
            for e in range(epochs) for i in range(leaves)}


def _drive(kv, rows, classes=40, epochs=2):
    tree = FleetTree.build(MulticlassConfusionMatrix(num_classes=classes, device="cpu"), (2, 2), kv=kv,
                           namespace="store", deadline_s=2.0, retry=FAST_RETRY)
    receipts = []
    for e in range(epochs):
        for i, leaf in enumerate(tree.leaves):
            for p, t in rows[(e, i)]:
                leaf.update(torch.as_tensor(p), torch.as_tensor(t))
        receipts.append(tree.run_epoch(e))
        receipts += [tree.nodes[r].last_rollup for r in ("region-00", "region-01")]
    tree.join_pending(timeout=5.0)
    return tree, receipts


def test_tree_over_a_store_equals_the_in_process_tree(store):
    rows = _rows()
    got, got_r = _drive(CoordinationServiceKV(store=store, poll_s=0.005), rows)
    want, want_r = _drive(InProcessKV(), rows)
    assert torch.equal(got.root.metric.confmat, want.root.metric.confmat)
    for rid in ("region-00", "region-01"):
        assert torch.equal(got.nodes[rid].metric.confmat, want.nodes[rid].metric.confmat)
    for a, b in zip(got_r, want_r):
        assert (a.node_id, a.contributing, a.missing, a.sources, a.partial, a.rows_folded) == (
            b.node_id, b.contributing, b.missing, b.sources, b.partial, b.rows_folded)
    assert got.root.folded_sources == {(leaf.node_id, e) for leaf in got.leaves for e in range(2)}
    # every folded key was deleted from the store
    assert not [k for k in store.list_keys() if k.startswith("tm_tpu/")]
    flat = np.concatenate([t * 40 + p for pairs in rows.values() for p, t in pairs])
    np.testing.assert_array_equal(got.root.metric.confmat.numpy(), np.bincount(flat, minlength=1600).reshape(40, 40))
