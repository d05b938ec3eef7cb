"""``RingBuffer`` and ``cat_state_capacity`` of the port against the JAX package, on the CPU.

Appends of seeded numpy batches go into both packages' ring buffers; the live
rows (in storage order), the validity mask, ``num_valid`` and ``num_dropped``
must be identical. ``CatMetric(cat_state_capacity=...)`` carries a ring-buffer
state through the ``Metric`` runtime: forward, update, reset, ``merge_state``,
``state_dict``/``load_state_dict``, clone and pickle, each compared with the
JAX package exactly (the rows are copied, never computed).
"""

import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as JA
from torchmetrics_tpu.utilities.ringbuffer import RingBuffer as JaxRingBuffer
from torchmetrics_tpu_torch.aggregation import CatMetric
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.ringbuffer import RingBuffer


def assert_rows(got, want):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def assert_same_buffer(rb, jrb):
    assert rb.num_valid == jrb.num_valid == len(rb)
    assert rb.num_dropped == jrb.num_dropped
    assert_rows(rb.values(), jrb.values())
    if jrb.initialized:
        data, valid = rb.masked()
        jdata, jvalid = jrb.masked()
        assert_rows(valid, jvalid)
        np.testing.assert_array_equal(data.numpy()[valid.numpy()], np.asarray(jdata)[np.asarray(jvalid)])


@pytest.mark.parametrize("sizes", [[3, 1], [2, 3, 4], [9], [5, 5, 5], [1] * 11, [4, 10, 2]])
@pytest.mark.parametrize("item_shape", [(), (2,)])
def test_wrap_around_matches_jax(sizes, item_shape):
    rng = np.random.default_rng(sum(sizes))
    rb, jrb = RingBuffer(4), JaxRingBuffer(4)
    assert_same_buffer(rb, jrb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in sizes:
            batch = rng.normal(size=(n, *item_shape)).astype(np.float32)
            rb.append(torch.from_numpy(batch))
            jrb.append(jnp.asarray(batch))
            assert_same_buffer(rb, jrb)
    assert rb.item_shape == tuple(jrb.item_shape) == item_shape


def test_overflow_warns_once():
    rb = RingBuffer(3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rb.append(torch.arange(3))
        assert not caught
        rb.append(torch.arange(2))
        rb.append(torch.arange(5))
    assert len([w for w in caught if "capacity (3) exceeded" in str(w.message)]) == 1
    assert rb.num_dropped == 7 and rb.count == 10
    assert rb.copy()._warned_overflow and not rb.copy_empty()._warned_overflow


def test_scalars_rows_and_shape_guard():
    rb = RingBuffer(5)
    rb.append(1.5)
    rb.extend([torch.tensor([2.5, 3.5]), 4.5])
    assert_rows(rb.values(), np.array([1.5, 2.5, 3.5, 4.5], np.float32))
    with pytest.raises(ValueError, match="rows of shape"):
        rb.append(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="positive integer"):
        RingBuffer(0)
    empty = RingBuffer(2)
    assert not empty.initialized and empty.values().shape == (0,) and empty.item_shape is None
    with pytest.raises(ValueError, match="no storage"):
        empty.masked()


def test_copy_on_write_keeps_copies_apart():
    rb = RingBuffer(4)
    rb.append(torch.arange(3.0))
    twin = rb.copy()
    assert twin.data is rb.data  # shared until one side writes
    twin.append(torch.tensor([7.0, 8.0]))
    rb.append(torch.tensor([9.0]))
    assert_rows(rb.values(), np.array([0, 1, 2, 9], np.float32))
    assert_rows(twin.values(), np.array([8, 1, 2, 7], np.float32))
    merged = rb.copy().extend(twin)
    assert merged.count == 8 and len(rb) == 4


@pytest.mark.parametrize("how", ["pickle", "deepcopy"])
def test_pickle_and_deepcopy_round_trip(how):
    rb = RingBuffer(4, device="cpu")
    rb.append(torch.arange(6.0).reshape(3, 2))
    shared = rb.copy()
    pair = [rb, shared]
    got = pickle.loads(pickle.dumps(pair)) if how == "pickle" else copy.deepcopy(pair)
    for before, after in zip(pair, got):
        assert after.capacity == 4 and after.count == 3 and after.device == torch.device("cpu")
        assert_rows(after.values(), before.values().numpy())
    got[0].append(torch.ones((1, 2)))  # the two unpickled buffers no longer share storage
    assert_rows(got[1].values(), shared.values().numpy())


def test_to_device_and_module_apply():
    rb = RingBuffer(3)
    rb.append(torch.arange(2, dtype=torch.float32))
    assert rb.to_device("cpu") is rb and rb.device == torch.device("cpu")
    metric = CatMetric(device="cpu", cat_state_capacity=3)
    metric.update(torch.arange(2.0))
    moved = metric.to("cpu", torch.float64)  # a device move: the dtype argument casts nothing, as in the JAX package
    assert moved.value.data.dtype == torch.float32 and moved._defaults["value"].device == torch.device("cpu")


class _TwoCatStates(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("rows", [], dist_reduce_fx="cat")
        self.add_state("kept", [], dist_reduce_fx=None)
        self.add_state("sums", torch.zeros(2), dist_reduce_fx="sum")
        self.add_state("listed", [], dist_reduce_fx=lambda x: x)

    def update(self, x):
        self.rows.append(x)
        self.kept.append(x[:1])
        self.sums += x.sum(0)
        self.listed.append(x)

    def compute(self):
        return self.sums


def test_add_state_replaces_cat_and_none_lists():
    metric = _TwoCatStates(device="cpu", cat_state_capacity=6)
    assert isinstance(metric.rows, RingBuffer) and isinstance(metric.kept, RingBuffer)
    assert isinstance(metric.listed, list) and isinstance(metric.sums, torch.Tensor)
    assert metric._defaults["rows"] is not metric.rows and metric.rows.capacity == 6
    with pytest.raises(ValueError, match="positive integer"):
        _TwoCatStates(device="cpu", cat_state_capacity=0)
    with pytest.raises(ValueError, match="dist_reduce_fx='cat'"):
        metric.add_state("bad", RingBuffer(3), dist_reduce_fx="sum")


def _pair(capacity, nan_strategy="warn"):
    return (JA.CatMetric(nan_strategy=nan_strategy, auto_compile=False, cat_state_capacity=capacity),
            CatMetric(nan_strategy=nan_strategy, device="cpu", cat_state_capacity=capacity))


def _batches(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for n in sizes]


def _jax_rows(value):
    """The JAX ``CatMetric`` returns its ring buffer itself from ``compute``; the port returns the rows."""
    return value.values() if isinstance(value, JaxRingBuffer) else value


@pytest.mark.parametrize("capacity", [7, 40])
def test_cat_metric_stream_matches_jax(capacity):
    """Forward and update alternate; past the capacity the oldest rows are overwritten, as in JAX."""
    jm, tm = _pair(capacity)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b, x in enumerate(_batches(1, [3, 5, 2, 4])):
            if b % 2 == 0:
                assert_rows(tm(torch.from_numpy(x)), _jax_rows(jm(jnp.asarray(x))))
            else:
                jm.update(jnp.asarray(x))
                tm.update(torch.from_numpy(x))
        assert_rows(tm.compute(), _jax_rows(jm.compute()))
    assert tm.value.num_dropped == jm.value.num_dropped


def test_reset_merge_state_and_state_dict_match_jax():
    data = _batches(2, [3, 4, 2, 5])
    ja, ta = _pair(12)
    jb, tb = _pair(12)
    for x in data[:2]:
        ja.update(jnp.asarray(x))
        ta.update(torch.from_numpy(x))
    for x in data[2:]:
        jb.update(jnp.asarray(x))
        tb.update(torch.from_numpy(x))
    ja.merge_state(jb)
    ta.merge_state(tb)
    assert ta.update_count == ja.update_count == 4
    assert_rows(ta.compute(), _jax_rows(ja.compute()))
    tb.update(torch.ones(3))  # the merge copied: the source streams on alone
    assert_rows(ta.compute(), _jax_rows(ja.compute()))

    ta.persistent(True)
    ja.persistent(True)
    saved = ta.state_dict(prefix="m.")
    assert_rows(saved["m.value"], ja.state_dict(prefix="m.")["m.value"])
    fresh = CatMetric(device="cpu", cat_state_capacity=12)
    fresh.load_state_dict(saved, prefix="m.")
    assert isinstance(fresh.value, RingBuffer) and fresh.value.count == 12
    assert_rows(fresh.compute(), _jax_rows(ja.compute()))
    as_list = CatMetric(device="cpu")
    as_list.load_state_dict(saved, prefix="m.")  # a ring-buffer checkpoint loads into a list state
    assert isinstance(as_list.value, list) and torch.equal(as_list.compute(), ta.compute())

    ta.reset()
    assert isinstance(ta.value, RingBuffer) and len(ta.value) == 0 and ta.update_count == 0


def test_merge_between_ring_and_list_states():
    data = _batches(3, [3, 4])
    ring, plain = CatMetric(device="cpu", cat_state_capacity=10), CatMetric(device="cpu")
    ring.update(torch.from_numpy(data[0]))
    plain.update(torch.from_numpy(data[1]))
    ring_copy, plain_copy = ring.clone(), plain.clone()
    ring.merge_state(plain_copy)
    plain.merge_state(ring_copy)
    assert_rows(ring.compute(), np.concatenate(data))
    assert_rows(plain.compute(), np.concatenate(data[::-1]))


@pytest.mark.parametrize("how", ["clone", "pickle"])
def test_clone_and_pickle_mid_stream(how):
    data = _batches(4, [5, 6, 3])
    tm = CatMetric(device="cpu", cat_state_capacity=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm.update(torch.from_numpy(data[0]))
        other = tm.clone() if how == "clone" else pickle.loads(pickle.dumps(tm))
        for metric in (tm, other):
            for x in data[1:]:
                metric.update(torch.from_numpy(x))
    assert torch.equal(tm.compute(), other.compute()) and other.value.num_dropped == 6


def test_sync_context_without_process_group_keeps_the_buffer():
    tm = CatMetric(device="cpu", cat_state_capacity=4)
    tm.update(torch.arange(3.0))
    with tm.sync_context():
        assert isinstance(tm.value, RingBuffer)
    assert_rows(tm.compute(), np.arange(3, dtype=np.float32))
