"""The port's StreamPool against the JAX package's, on the CPU.

From ``tests/unittests/streams/test_pool.py`` (15 tests): lifecycle, masked
padding, growth and its named recompile, the manifest gate, the NaN
quarantine and the dropped violations per row, the value cache, ring states,
``state_dict``, the bounded labels. Each scenario runs through both packages
on the same seeded numpy batches (the port with ``device="cpu"``) and the
results are compared. Added for the port: kernel B1's plain version and its
lane-batched custom op under ``torch.func.vmap``, bit for bit with a call a
lane; an op with no batching rule raises inside a pooled update (no per-lane
fallback); ``warm_start``'s outcomes (the card's tests are in ``test_torch_streams_card.py``).
"""

import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu._streams as j_streams
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch._streams as t_streams
from torchmetrics_tpu._analysis.manifest import stream_pool_eligible as jax_stream_pool_eligible
from torchmetrics_tpu._observability import set_telemetry_enabled as j_set_telemetry
from torchmetrics_tpu._observability.telemetry import REGISTRY as J_REGISTRY
from torchmetrics_tpu._observability.telemetry import RecompileChurnWarning as JChurn
from torchmetrics_tpu._observability.telemetry import telemetry_for as j_telemetry_for
from torchmetrics_tpu.metric import Metric as JMetric
from torchmetrics_tpu.utilities.exceptions import TorchMetricsUserError as JUserError
from torchmetrics_tpu_torch._observability import set_telemetry_enabled as t_set_telemetry
from torchmetrics_tpu_torch._observability.telemetry import REGISTRY as T_REGISTRY
from torchmetrics_tpu_torch._observability.telemetry import RecompileChurnWarning as TChurn
from torchmetrics_tpu_torch._observability.telemetry import telemetry_for as t_telemetry_for
from torchmetrics_tpu_torch._streams.manifest import stream_pool_eligible
from torchmetrics_tpu_torch._streams.telemetry import OVERFLOW_LABEL
from torchmetrics_tpu_torch.functional.classification import _confmat_kernel as K
from torchmetrics_tpu_torch.metric import Metric as TMetric
from torchmetrics_tpu_torch.utilities.checks import _no_vmap_fallback
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError as TUserError


def _side(is_jax: bool) -> types.SimpleNamespace:
    """One package behind one interface: its modules, array maker and constructor kwargs."""
    if is_jax:
        return types.SimpleNamespace(
            name="jax", tm=jtm, streams=j_streams, kw={}, arr=lambda a: jnp.asarray(np.asarray(a)),
            UserError=JUserError, Churn=JChurn, telemetry_for=j_telemetry_for, set_telemetry=j_set_telemetry,
            REGISTRY=J_REGISTRY, Metric=JMetric, zeros=jnp.zeros, ones=jnp.ones, sum=jnp.sum,
        )
    return types.SimpleNamespace(
        name="port", tm=ttm, streams=t_streams, kw={"device": "cpu"}, arr=lambda a: torch.as_tensor(np.asarray(a)),
        UserError=TUserError, Churn=TChurn, telemetry_for=t_telemetry_for, set_telemetry=t_set_telemetry,
        REGISTRY=T_REGISTRY, Metric=TMetric, zeros=lambda s: torch.zeros(s), ones=lambda s: torch.ones(s),
        sum=torch.sum,
    )


JAX, PORT = _side(True), _side(False)


def both(fn):
    return fn(JAX), fn(PORT)


def host(x):
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(a, b, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(host(a), np.float64), np.asarray(host(b), np.float64), rtol=rtol, atol=atol)


def _mse_batches(n_calls, b, n=8, seed=77):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((b, n)).astype(np.float32), rng.standard_normal((b, n)).astype(np.float32))
        for _ in range(n_calls)
    ]


def _ids(*ids):
    return np.asarray(ids, np.int32)


def test_attach_detach_reset_lifecycle():
    (p1, t1), (p2, t2), (p3, t3) = _mse_batches(3, 2)

    def run(S):
        pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=4)
        a, b = pool.attach(), pool.attach()
        assert (a, b) == (0, 1)
        pool.update(_ids(a, b), S.arr(p1), S.arr(t1))
        assert pool.stream_update_count(a) == 1
        pool.reset(a)
        assert pool.stream_update_count(a) == 0
        # a reset stream computes its own value again; the other keeps its stream
        pool.update(_ids(a, b), S.arr(p2), S.arr(t2))
        want = S.tm.MeanSquaredError(**S.kw)
        want.update(S.arr(p2[0]), S.arr(t2[0]))
        close(pool.compute(a), want.compute())
        got = (host(pool.compute(a)), host(pool.compute(b)))
        pool.detach(a)
        with pytest.raises(S.UserError, match="not attached"):
            pool.compute(a)
        with pytest.raises(S.UserError, match="not attached"):
            pool.update(_ids(a), S.arr(p3[:1]), S.arr(t3[:1]))
        # the freed slot is recycled lowest-first
        assert pool.attach() == a
        return got

    j, p = both(run)
    close(j[0], p[0])
    close(j[1], p[1])


def test_free_list_doubles_capacity_and_names_the_recompile():
    (p1, t1), (p2, t2) = _mse_batches(2, 2)

    def run(S):
        S.set_telemetry(True)
        try:
            pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=2)
            s0, s1 = pool.attach(), pool.attach()
            pool.update(_ids(s0, s1), S.arr(p1), S.arr(t1))
            s2 = pool.attach()  # the free-list is empty: the capacity doubles
            assert pool.capacity == 4 and pool.growths == 1
            assert s2 == 2
            # the step of the new capacity is built once and the churn detector names `capacity`
            with pytest.warns(S.Churn, match="capacity"):
                pool.update(_ids(s0, s2), S.arr(p2), S.arr(t2))
            telem = S.telemetry_for(pool, create=False)
            assert telem.counters.get("compiles|kind=stream_step") == 2
            assert "capacity" in (telem.last_churn_diff or "")
            return host(pool.compute(s0)), telem.last_churn_diff
        finally:
            S.set_telemetry(False)

    j, p = both(run)
    close(j[0], p[0])
    assert j[1] == p[1]


def test_growth_preserves_stream_state():
    ((p, t),) = _mse_batches(1, 1)

    def run(S):
        pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=1)
        eager = S.tm.MeanSquaredError(**S.kw)
        s0 = pool.attach()
        pool.update(_ids(s0), S.arr(p), S.arr(t))
        eager.update(S.arr(p[0]), S.arr(t[0]))
        for _ in range(3):  # 1 -> 2 -> 4 (and one more attach inside 4)
            pool.attach()
        assert pool.capacity == 4 and pool.growths == 2
        close(pool.compute(s0), eager.compute())
        return host(pool.compute(s0))

    j, p_ = both(run)
    close(j, p_)


def test_masked_padding_and_duplicate_rejection():
    ((p, t),) = _mse_batches(1, 2)

    def run(S):
        pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=2)
        s0 = pool.attach()
        eager = S.tm.MeanSquaredError(**S.kw)
        pool.update(_ids(s0, -1), S.arr(p), S.arr(t))  # the padding row is masked out
        eager.update(S.arr(p[0]), S.arr(t[0]))
        close(pool.compute(s0), eager.compute())
        with pytest.raises(S.UserError, match="duplicate"):
            pool.update(_ids(s0, s0), S.arr(p), S.arr(t))
        return host(pool.compute(s0))

    j, p_ = both(run)
    close(j, p_)


def _user_metric(S):
    class _UserMetric(S.Metric):
        def __init__(self):
            super().__init__(**S.kw)
            self.add_state("s", default=S.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.s = self.s + S.sum(x)

        def compute(self):
            return self.s

    return _UserMetric


def test_manifest_gate_refuses_host_bound_and_unknown():
    def run(S):
        assert (jax_stream_pool_eligible if S is JAX else stream_pool_eligible)(S.tm.text.WordErrorRate) == "host_bound"
        with pytest.raises(S.streams.StreamPoolUnsupported, match="does not trace"):
            S.tm.text.WordErrorRate(**S.kw).to_stream_pool()
        cls = _user_metric(S)
        assert (jax_stream_pool_eligible if S is JAX else stream_pool_eligible)(cls) == "unknown"
        with pytest.raises(S.streams.StreamPoolUnsupported, match="absent from the eligibility manifest"):
            cls().to_stream_pool()
        # the explicit opt-in works (the body does trace)
        pool = cls().to_stream_pool(enforce_manifest=False, capacity=2)
        s = pool.attach()
        pool.update(_ids(s), S.ones((1, 4)))
        return host(pool.compute(s))

    j, p = both(run)
    close(j, 4.0)
    close(p, 4.0)


def test_used_template_refused():
    ((p, t),) = _mse_batches(1, 1)

    def run(S):
        m = S.tm.MeanSquaredError(**S.kw)
        m.update(S.arr(p[0]), S.arr(t[0]))
        with pytest.raises(S.streams.StreamPoolUnsupported, match="fresh template"):
            m.to_stream_pool()

    both(run)


def test_nan_quarantine_per_row():
    (p1, t1), (p2, t2) = _mse_batches(2, 2)
    p2 = p2.copy()
    p2[1, 0] = np.nan  # only stream b's row

    def run(S):
        pool = S.tm.MeanSquaredError(nan_policy="quarantine", **S.kw).to_stream_pool(capacity=2)
        a, b = pool.attach(), pool.attach()
        eager = S.tm.MeanSquaredError(**S.kw)
        pool.update(_ids(a, b), S.arr(p1), S.arr(t1))
        eager.update(S.arr(p1[0]), S.arr(t1[0]))
        pool.update(_ids(a, b), S.arr(p2), S.arr(t2))
        eager.update(S.arr(p2[0]), S.arr(t2[0]))
        assert pool.quarantined_updates(b) == 1
        assert pool.quarantined_updates(a) == 0
        assert pool.stream_update_count(b) == 1  # rolled back
        assert pool.stream_update_count(a) == 2
        close(pool.compute(a), eager.compute())
        return host(pool.compute(a)), host(pool.compute(b))

    j, p = both(run)
    close(j[0], p[0])
    close(j[1], p[1])


def test_error_violation_drops_row():
    rng = np.random.default_rng(5)
    p = rng.random((1, 8)).astype(np.float32)
    t = rng.integers(0, 2, (1, 8))
    bad = t.copy()
    bad[0, 0] = 9  # out of the target set

    def run(S):
        pool = S.tm.BinaryAccuracy(**S.kw).to_stream_pool(capacity=2)
        s = pool.attach()
        pool.update(_ids(s), S.arr(p), S.arr(t))
        pool.update(_ids(s), S.arr(p), S.arr(bad))
        assert pool.pending_violations(s) == 1
        assert pool.stream_update_count(s) == 1
        eager = S.tm.BinaryAccuracy(validate_args=False, **S.kw)
        eager.update(S.arr(p[0]), S.arr(t[0]))
        close(pool.compute(s), eager.compute())
        return host(pool.compute(s))

    j, p_ = both(run)
    close(j, p_)


def test_warn_nan_policy_refused_at_construction():
    def run(S):
        with pytest.raises(S.streams.StreamPoolUnsupported, match="nan_policy"):
            S.tm.MeanSquaredError(nan_policy="warn", **S.kw).to_stream_pool()

    both(run)


def test_compute_cache_bits():
    (p1, t1), (p2, t2), (p3, t3) = _mse_batches(3, 2)

    def run(S):
        pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=2)
        a, b = pool.attach(), pool.attach()
        pool.update(_ids(a, b), S.arr(p1), S.arr(t1))
        va = pool.compute(a)
        assert pool.compute(a) is va  # a cache hit: the same object, no recompute
        pool.update(_ids(b), S.arr(p2[:1]), S.arr(t2[:1]))  # does not touch a
        assert pool.compute(a) is va  # a's cache bit survived b's update
        vb = pool.compute(b)
        pool.update(_ids(b), S.arr(p3[:1]), S.arr(t3[:1]))
        assert pool.compute(b) is not vb  # b's update invalidated b's bit
        return host(va), host(pool.compute(b))

    j, p = both(run)
    close(j[0], p[0])
    close(j[1], p[1])


def test_ring_cat_states_vmap():
    """The JAX test's streams (PearsonCorrCoef, sum states), and a ring-buffer cat state the port stacks."""
    batches = _mse_batches(3, 2, n=16)

    def run(S):
        pool = S.tm.PearsonCorrCoef(**S.kw).to_stream_pool(capacity=2)
        a, b = pool.attach(), pool.attach()
        eagers = {a: S.tm.PearsonCorrCoef(**S.kw), b: S.tm.PearsonCorrCoef(**S.kw)}
        for p, t in batches:
            pool.update(_ids(a, b), S.arr(p), S.arr(t))
            for i, sid in enumerate((a, b)):
                eagers[sid].update(S.arr(p[i]), S.arr(t[i]))
        for sid in (a, b):
            close(pool.compute(sid), eagers[sid].compute(), rtol=1e-4, atol=1e-6)
        return [host(pool.compute(sid)) for sid in (a, b)]

    j, p = both(run)
    close(j, p, rtol=1e-4, atol=1e-6)

    # the port's ring states: data, valid and an int64 count per slot; a ring wraps per stream
    pool = ttm.CatMetric(device="cpu", cat_state_capacity=5, nan_strategy="disable").to_stream_pool(capacity=2)
    x, y = pool.attach(), pool.attach()
    eagers = {sid: ttm.CatMetric(device="cpu", cat_state_capacity=5, nan_strategy="disable") for sid in (x, y)}
    rng = np.random.default_rng(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the eager rings warn as they wrap
        for ids in ((x, y), (x,), (x, y), (x,)):
            rows = rng.standard_normal((len(ids), 2)).astype(np.float32)
            pool.update(_ids(*ids), torch.from_numpy(rows))
            for i, sid in enumerate(ids):
                eagers[sid].update(torch.from_numpy(rows[i]))
    state = pool.state_dict()
    assert state["value#count"][[x, y]].tolist() == [8, 4] and state["value#valid"][x].all()
    assert state["value#valid"][y].tolist() == [True] * 4 + [False]
    every = pool.compute_all()
    for sid in (x, y):
        assert torch.equal(pool.compute(sid), eagers[sid].compute())
        assert torch.equal(every[sid], eagers[sid].compute())


def test_state_dict_roundtrip():
    ((p, t),) = _mse_batches(1, 2)

    def run(S):
        pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=4)
        a, b = pool.attach(), pool.attach()
        pool.update(_ids(a, b), S.arr(p), S.arr(t))
        sd = pool.state_dict(integrity=True, all_states=True)
        assert "#streams" in sd and sd["#streams"]["capacity"] == 4
        fresh = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=2)  # the capacity becomes the snapshot's
        fresh.load_state_dict(sd, strict=True)
        assert fresh.capacity == 4
        assert fresh.active_streams == [a, b]
        close(fresh.compute(a), pool.compute(a))
        assert fresh.stream_update_count(b) == pool.stream_update_count(b)
        return host(fresh.compute(a)), sorted(k for k in sd if not k.startswith("#"))

    j, p_ = both(run)
    close(j[0], p_[0])
    assert j[1] == p_[1]


def test_stream_labeler_topk_overflow_rebalance():
    def run(S):
        lab = S.streams.StreamLabeler(k=2, rebalance_every=10)
        out = [lab.note(0), lab.note(1), lab.note(2)]
        assert out == ["0", "1", OVERFLOW_LABEL]  # the label slots are full
        for _ in range(20):
            lab.note(2)  # stream 2 turns noisy; the rebalance promotes it
        assert lab.label(2) == "2"
        # the quietest labelled stream was evicted to the overflow bucket
        assert OVERFLOW_LABEL in (lab.label(0), lab.label(1))
        labels = (lab.label(0), lab.label(1), lab.label(2))
        lab.retire(2)
        assert lab.label(2) == OVERFLOW_LABEL
        return labels

    j, p = both(run)
    assert j == p


def test_per_stream_labels_in_prometheus_export():
    batches = _mse_batches(2, 2)

    def run(S):
        S.REGISTRY.reset()  # other tests' pools would leak their labels into the scrape
        S.set_telemetry(True)
        try:
            pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=2, telemetry_streams=1)
            a, b = pool.attach(), pool.attach()
            for p, t in batches:
                pool.update(_ids(a, b), S.arr(p), S.arr(t))
            text = S.REGISTRY.render_prometheus()
            assert 'stream="0"' in text
            assert f'stream="{OVERFLOW_LABEL}"' in text  # the bounded label dimension
            assert 'stream="1"' not in text  # k=1: the second stream rides the overflow
            return sorted(line.split(" ")[0] for line in text.splitlines() if line.startswith("tm_tpu_pool_stream_updates"))
        finally:
            S.set_telemetry(False)
            S.REGISTRY.reset()

    j, p = both(run)
    assert j == p


def test_update_shape_mismatch_rejected():
    ((p, t),) = _mse_batches(1, 2)

    def run(S):
        pool = S.tm.MeanSquaredError(**S.kw).to_stream_pool(capacity=2)
        s = pool.attach()
        with pytest.raises(S.UserError, match="leading stream axis"):
            pool.update(_ids(s), S.arr(p), S.arr(t))  # rows != ids

    both(run)


# ------------------------------------------------------------------ added for the port
@pytest.mark.parametrize("num_classes", [4, 300])
@pytest.mark.parametrize("masked", [False, True])
def test_b1_plain_version_under_vmap_is_bit_for_bit_a_call_a_lane(num_classes, masked):
    """B1's plain version vmaps without the per-lane fallback, and so do the lane-batched op and its plain version."""
    rng = np.random.default_rng(num_classes + masked)
    lanes, n = 6, 1031
    preds = torch.from_numpy(rng.integers(-2, num_classes + 2, (lanes, n)))
    target = torch.from_numpy(rng.integers(-2, num_classes + 2, (lanes, n)))
    mask = torch.from_numpy(rng.random((lanes, n)) < 0.7) if masked else None
    want = torch.stack([
        K.confusion_matrix_plain(preds[b], target[b], num_classes, None if mask is None else mask[b]) for b in range(lanes)
    ])
    args = (preds, target) if mask is None else (preds, target, mask)
    with torch.no_grad():
        with _no_vmap_fallback():
            got = torch.func.vmap(lambda p, t, *m: K.confusion_matrix_plain(p, t, num_classes, *m))(*args)
            out = torch.zeros((lanes, num_classes, num_classes), dtype=torch.int32)

            def lane(p, t, o, *m):
                K._confmat_op()(p, t, m[0] if m else None, num_classes, o)
                return o

            torch.func.vmap(lane)(preds, target, out, *(() if mask is None else (mask,)))
    assert torch.equal(got, want) and got.dtype == torch.int32
    assert torch.equal(out, want)
    assert torch.equal(K.confusion_matrix_lanes_plain(preds, target, num_classes, mask), want)
    assert int(K.confusion_matrix_lanes.launches) == 0  # the CPU launches nothing


def test_an_op_without_a_batching_rule_raises_inside_a_pooled_update():
    """No lane-by-lane fallback: ``bincount`` has no batching rule, so the pooled update raises and nothing lands."""

    class _Histogram(TMetric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("h", default=torch.zeros(4, dtype=torch.int64), dist_reduce_fx="sum")

        def update(self, x):
            self.h += torch.bincount(x, minlength=4)[:4]

        def compute(self):
            return self.h

    pool = _Histogram().to_stream_pool(enforce_manifest=False, capacity=2)
    a, b = pool.attach(), pool.attach()
    assert torch._C._functorch._is_vmap_fallback_enabled()
    with pytest.raises(RuntimeError, match="vmap fallback which is currently disabled"):
        pool.update(_ids(a, b), torch.tensor([[0, 1, 1], [2, 3, 3]]))
    assert torch._C._functorch._is_vmap_fallback_enabled()  # switched back on after the step
    assert pool.stream_update_count(a) == pool.stream_update_count(b) == 0
    assert torch.equal(pool.compute(a), torch.zeros(4, dtype=torch.int64))


def test_warm_start_builds_the_step_without_consuming_a_batch():
    ((p, t),) = _mse_batches(1, 2)
    pool = ttm.MeanSquaredError(device="cpu").to_stream_pool(capacity=2)
    a, b = pool.attach(), pool.attach()
    out = pool.warm_start(_ids(a, b), torch.from_numpy(p), torch.from_numpy(t))
    assert out == {"stream_step": "compiled", "stream_compute_one": "ready", "stream_compute_all": "ready"}
    assert pool.stream_update_count(a) == pool.stream_update_count(b) == 0
    state = pool.state_dict()
    assert not state["sum_squared_error"][[a, b]].any() and not state["total"][[a, b]].any()  # no row landed
    assert set(pool.warm_start(_ids(a, b), torch.from_numpy(p), torch.from_numpy(t)).values()) == {"ready"}
    steps = dict(pool._step_fns)
    pool.update(_ids(a, b), torch.from_numpy(p), torch.from_numpy(t))
    assert pool._step_fns == steps  # the update ran the warmed step
    eager = ttm.MeanSquaredError(device="cpu")
    eager.update(torch.from_numpy(p[0]), torch.from_numpy(t[0]))
    assert torch.equal(pool.compute(a), eager.compute())
    pool.attach()  # a growth: a new capacity is a new key
    assert pool.warm_start(_ids(a, b), torch.from_numpy(p), torch.from_numpy(t))["stream_step"] == "compiled"
    # the JAX package's disk route ("hit") waits for the port's `_aot/`
    assert "_aot/" in type(pool).warm_start.__doc__ and '"hit"' in type(pool).warm_start.__doc__


def test_a_failed_capture_keeps_the_key_eager_and_is_reported(monkeypatch):
    from torchmetrics_tpu_torch import _compile
    from torchmetrics_tpu_torch._observability.events import BUS

    ((p, t),) = _mse_batches(1, 2)
    pool = ttm.MeanSquaredError(device="cpu").to_stream_pool(capacity=2)
    a, b = pool.attach(), pool.attach()
    pool.update(_ids(a, b), torch.from_numpy(p), torch.from_numpy(t))
    ((key, step),) = pool._step_fns.items()

    def refuse(*args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    # the capture path as the card takes it, with the capture itself refused
    monkeypatch.setattr(_compile, "CapturedStep", refuse)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    dyn = [torch.tensor([a, b]), torch.from_numpy(p), torch.from_numpy(t)]
    t_set_telemetry(True)
    try:
        with pytest.warns(UserWarning, match="did not capture into a CUDA graph.*runs eagerly"):
            got = pool._capture(key, step, dyn)
        telem = t_telemetry_for(pool, create=False)
        assert telem.counters.get("auto_path_disabled") == 1
        (event,) = [e for e in BUS.events("auto_path_disabled") if e.source == "StreamPool[MeanSquaredError]"][-1:]
        assert event.data == {"seam": "stream_step", "key": repr(key)}
        assert "operation not permitted" in event.detail
    finally:
        t_set_telemetry(False)
    assert got is step  # the key keeps its eager step
    assert pool.capture_failures == {key: "RuntimeError: operation not permitted when stream is capturing"}
