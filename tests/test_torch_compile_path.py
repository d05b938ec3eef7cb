"""The port's compiled update path against the JAX package's auto-compile, on the CPU.

Follows ``tests/unittests/bases/test_auto_compile.py`` case for case where the
port has the feature. The JAX side runs with its default ``auto_compile=True``
(one XLA executable per repeat signature) and the port with its own default
(a CPU metric runs the same step function eagerly that a CUDA metric captures
into a CUDA graph), so compiled is held against compiled: the same numpy
inputs, the same call that raises, the same message. Counts are compared
exactly; float results within ``rtol=1e-6`` (float32 sums in another order),
or 1e-5 where the JAX test itself allows it.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as JM
import torchmetrics_tpu_torch as TM
from torchmetrics_tpu_torch.utilities.checks import _compiled_step

RTOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def pair(name, **kwargs):
    """The JAX class at its default ``auto_compile`` and the port's on the CPU."""
    return getattr(JM, name)(**kwargs), getattr(TM, name)(device="cpu", **kwargs)


def feed(jm, tm, *arrays, method="update"):
    """One call of ``method`` on both sides with the same numpy arrays; returns both results."""
    return (getattr(jm, method)(*(jnp.asarray(a) for a in arrays)),
            getattr(tm, method)(*(torch.from_numpy(np.asarray(a)) for a in arrays)))


def assert_same(got, want, rtol=RTOL, atol=0.0):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k], rtol, atol)
        return
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            assert_same(g, w, rtol, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, equal_nan=True)


def assert_states_equal(jm, tm):
    assert tm._update_count == jm._update_count
    for name in jm._defaults:
        want, got = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=name)


def engaged(m, cache="_auto_update_fn"):
    return bool(m.__dict__.get(cache)) and not m._auto_disabled


class _FirstPixels:
    """A feature extractor for either package: each image's first four values, as floats."""

    num_features = 4

    def __call__(self, imgs):
        return imgs.reshape(imgs.shape[0], -1)[:, :4] * 1.0


def _batches(n=4, b=32, c=5, seed=123):
    rng = _rng(seed)
    return [(rng.random((b, c)).astype(np.float32), rng.integers(0, c, b)) for _ in range(n)]


class TestAutoUpdateParity:
    def test_engages_and_matches_eager(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5, validate_args=False)
        eager = TM.MulticlassAccuracy(num_classes=5, validate_args=False, device="cpu", auto_compile=False)
        for p, t in _batches():
            feed(jm, tm, p, t)
            eager.update(torch.from_numpy(p), torch.from_numpy(t))
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        assert not engaged(eager)
        assert_states_equal(jm, tm)
        assert_same(tm.compute(), jm.compute())
        assert torch.equal(tm.compute(), eager.compute())

    def test_forward_engages_and_matches_eager(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5, validate_args=False)
        for p, t in _batches(seed=5):
            vj, vt = feed(jm, tm, p, t, method="forward")
            assert_same(vt, vj)
        assert engaged(tm, "_auto_forward_fn") and "_auto_forward_fn" in jm.__dict__
        assert_same(tm.compute(), jm.compute())

    def test_forward_mean_reduction_weighting(self):
        jm, tm = pair("MeanSquaredError")
        rng = _rng(7)
        for _ in range(5):
            p, t = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
            vj, vt = feed(jm, tm, p, t, method="forward")
            assert_same(vt, vj)
        assert engaged(tm, "_auto_forward_fn")
        assert_same(tm.compute(), jm.compute())

    def test_forward_mean_reduced_state_is_weighted_by_the_previous_count(self):
        """A ``mean`` state merged in the compiled forward: ``(n * g + batch) / (n + 1)``, as the eager path."""

        class MeanOfMeans(TM.Metric):
            full_state_update = False

            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                self.add_state("m", torch.tensor(0.0), dist_reduce_fx="mean")

            def update(self, x):
                self.m += x.mean()

            def compute(self):
                return self.m

        auto, eager = MeanOfMeans(device="cpu"), MeanOfMeans(device="cpu", auto_compile=False)
        for seed in range(6):
            x = torch.from_numpy(_rng(seed).random(8).astype(np.float32))
            assert torch.equal(auto(x), eager(x))
        assert engaged(auto, "_auto_forward_fn")
        assert torch.equal(auto.m, eager.m) and auto.update_count == eager.update_count == 6

    def test_validate_args_true_compiles_with_fused_checks(self):
        jm, tm = pair("BinaryStatScores")
        rng = _rng(11)
        good_p, good_t = rng.random(8).astype(np.float32), rng.integers(0, 2, 8)
        for _ in range(3):
            feed(jm, tm, good_p, good_t)
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        feed(jm, tm, good_p, np.full(8, 7))  # replayed: the violation is recorded on the device
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match="outside of the expected set"):
                m.compute()
        assert_same(tm.compute(), jm.compute())  # the raise cleared the flags

    def test_violating_batch_does_not_contaminate_state(self):
        jm, tm = pair("BinaryStatScores")
        clean = TM.BinaryStatScores(device="cpu", auto_compile=False)
        rng = _rng(12)
        p, t = rng.random(8).astype(np.float32), rng.integers(0, 2, 8)
        for _ in range(3):
            feed(jm, tm, p, t)
            clean.update(torch.from_numpy(p), torch.from_numpy(t))
        feed(jm, tm, p, np.full(8, 7))
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match="outside of the expected set"):
                m.compute()
        assert torch.equal(tm.compute(), clean.compute())
        assert_same(tm.compute(), jm.compute())

    @pytest.mark.parametrize(
        ("name", "kwargs", "match"),
        [
            ("BinaryStatScores", {}, "outside of the expected set"),  # counts masked by the keep flag
            ("MulticlassAccuracy", {"num_classes": 5}, "more unique values"),  # counts masked by the keep flag
            ("BinaryConfusionMatrix", {}, "outside of the expected set"),  # states copied, chosen after
            ("MeanMetric", {"nan_strategy": "error"}, "nan"),  # states copied, chosen after
        ],
    )
    def test_violating_batch_with_valid_rows_is_dropped(self, name, kwargs, match):
        """One bad element among valid rows: the batch would add to every state, and adds nothing."""
        jm, tm = pair(name, **kwargs)
        clean = getattr(TM, name)(device="cpu", auto_compile=False, **kwargs)
        rng = _rng(21)
        if name == "MeanMetric":
            good = (rng.random(16).astype(np.float32),)
            bad = (good[0].copy(),)
            bad[0][3] = np.nan
        else:
            c = kwargs.get("num_classes", 2)
            p = rng.random((16, c)).astype(np.float32) if c > 2 else rng.random(16).astype(np.float32)
            good = (p, rng.integers(0, c, 16))
            bad = (p, good[1].copy())
            bad[1][3] = c + 4
        for i in range(4):
            feed(jm, tm, *(bad if i == 2 else good))
            if i != 2:
                clean.update(*(torch.from_numpy(a) for a in good))
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match=match):
                m.compute()
        for n in clean._defaults:
            assert torch.equal(getattr(tm, n), getattr(clean, n)), n
        assert_same(tm.compute(), jm.compute())

    def test_mixed_dtype_signatures_keep_flags_aligned(self):
        jm, tm = pair("BinaryStatScores")
        rng = _rng(13)
        pf, pi, t = rng.random(8).astype(np.float32), rng.integers(0, 2, 8), rng.integers(0, 2, 8)
        for _ in range(3):
            feed(jm, tm, pf, t)
        for _ in range(3):
            feed(jm, tm, pi, t)
        assert not tm._auto_disabled and len(tm.__dict__["_auto_update_fn"]) == 2
        feed(jm, tm, np.full(8, 3), t)
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match="binary set"):
                m.compute()

    def test_update_reassigning_array_attribute_disables_auto(self):
        class Caching(TM.SumMetric):
            def update(self, value):
                self.last_batch = value
                super().update(value)

        m = Caching(device="cpu")
        x = torch.ones(4)
        for i in range(5):
            m.update(x + i)
        assert m._auto_disabled and "unregistered" in m._auto_disabled_reason
        assert torch.equal(m.last_batch, x + 4)

    def test_violating_forward_batch_value_is_poisoned(self):
        jm, tm = pair("BinaryStatScores")
        rng = _rng(14)
        p, t = rng.random(8).astype(np.float32), rng.integers(0, 2, 8)
        for _ in range(3):
            feed(jm, tm, p, t, method="forward")
        oj, ot = feed(jm, tm, p, np.full(8, 7), method="forward")
        assert int(ot.min()) == torch.iinfo(ot.dtype).min
        assert int(np.asarray(oj).min()) == np.iinfo(np.asarray(oj).dtype).min
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match="outside of the expected set"):
                m.compute()

    @pytest.mark.parametrize(
        ("cls_name", "kwargs", "maker"), [
            ("BinaryAUROC", {"thresholds": 32}, "binary"),
            ("MulticlassAveragePrecision", {"num_classes": 4, "thresholds": 32}, "multiclass"),
            ("MultilabelROC", {"num_labels": 3, "thresholds": 32}, "multilabel"),
            ("BinaryHingeLoss", {}, "binary"),
            ("MultilabelRankingLoss", {"num_labels": 3}, "multilabel"),
            ("MulticlassExactMatch", {"num_classes": 4}, "multiclass_labels"),
        ],
    )
    def test_ctor_default_families_auto_compile(self, cls_name, kwargs, maker):
        def batch(i):
            r = _rng(60_000 + i)
            if maker == "binary":
                return r.random(32).astype(np.float32), r.integers(0, 2, 32)
            if maker == "multiclass":
                p = r.random((32, 4)).astype(np.float32)
                return p / p.sum(1, keepdims=True), r.integers(0, 4, 32)
            if maker == "multiclass_labels":
                return r.integers(0, 4, (32, 5)), r.integers(0, 4, (32, 5))
            return r.random((32, 3)).astype(np.float32), r.integers(0, 2, (32, 3))

        jm, tm = pair(cls_name, **kwargs)
        eager = getattr(TM, cls_name)(device="cpu", auto_compile=False, **kwargs)
        assert tm.validate_args is True
        for i in range(4):
            p, t = batch(i)
            feed(jm, tm, p, t)
            eager.update(torch.from_numpy(p), torch.from_numpy(t))
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__, tm._auto_disabled_reason
        assert_same(tm.compute(), jm.compute(), rtol=1e-5, atol=1e-6)
        assert_same(tm.compute(), eager.compute(), rtol=0, atol=0)

    def test_binned_curve_deferred_violation(self):
        jm, tm = pair("BinaryAUROC", thresholds=32)
        rng = _rng(15)
        p, t = rng.random(16).astype(np.float32), rng.integers(0, 2, 16)
        for _ in range(3):
            feed(jm, tm, p, t)
        feed(jm, tm, p, np.full(16, 4))
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match="outside of the expected set"):
                m.compute()

    def test_demographic_parity_ignores_raw_target_like_eager(self):
        jm, tm = pair("BinaryFairness", num_groups=2, task="demographic_parity")
        eager = TM.BinaryFairness(num_groups=2, task="demographic_parity", device="cpu", auto_compile=False)
        rng = _rng(16)
        p, t, g = rng.random(16).astype(np.float32), np.full(16, 7), rng.integers(0, 2, 16)
        for _ in range(4):
            feed(jm, tm, p, t, g)
            eager.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(g))
        assert engaged(tm)
        assert_same(tm.compute(), jm.compute())
        assert_same(tm.compute(), eager.compute(), rtol=0)

    def test_group_fairness_deferred_violation(self):
        jm, tm = pair("BinaryGroupStatRates", num_groups=2)
        rng = _rng(17)
        p, t, g = rng.random(16).astype(np.float32), rng.integers(0, 2, 16), rng.integers(0, 2, 16)
        for _ in range(3):
            feed(jm, tm, p, t, g)
        feed(jm, tm, p, t, np.full(16, 9))
        for m in (jm, tm):
            with pytest.raises(RuntimeError, match="number of groups"):
                m.compute()

    def test_validate_args_true_first_call_still_raises_eagerly(self):
        jm, tm = pair("BinaryStatScores")
        p = _rng(18).random(8).astype(np.float32)
        with pytest.raises(RuntimeError, match="Detected the following values"):
            jm.update(jnp.asarray(p), jnp.asarray(np.full(8, 7)))
        with pytest.raises(RuntimeError, match="Detected the following values"):
            tm.update(torch.from_numpy(p), torch.from_numpy(np.full(8, 7)))

    def test_validated_compiled_values_match_eager(self):
        jm, tm = pair("BinaryStatScores")
        eager = TM.BinaryStatScores(device="cpu", auto_compile=False)
        rng = _rng(19)
        for _ in range(4):
            p, t = rng.random(16).astype(np.float32), rng.integers(0, 2, 16)
            feed(jm, tm, p, t)
            eager.update(torch.from_numpy(p), torch.from_numpy(t))
        assert torch.equal(tm.compute(), eager.compute())
        assert_same(tm.compute(), jm.compute())

    def test_update_mutating_plain_attribute_disables_auto(self):
        class Counting(TM.SumMetric):
            def __init__(self):
                super().__init__(device="cpu")
                self.n_calls = 0

            def update(self, value):
                self.n_calls += 1
                super().update(value)

        m = Counting()
        for _ in range(5):
            m.update(torch.ones(4))
        assert m._auto_disabled and m.n_calls == 5
        assert float(m.compute()) == 20.0

    def test_aggregator_nan_ignore_compiles_branchless(self):
        jm, tm = pair("MeanMetric", nan_strategy="ignore")
        x = np.array([1.0, 2.0, np.nan, 4.0], np.float32)
        for _ in range(3):
            feed(jm, tm, x)
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        assert_same(tm.compute(), jm.compute())
        np.testing.assert_allclose(float(tm.compute()), 7.0 / 3.0, rtol=RTOL)

    def test_aggregator_warn_strategy_surfaces_at_compute(self):
        """The default ``"warn"`` strategy compiles: the NaN is dropped, and the warning comes at ``compute()``."""
        jm, tm = pair("SumMetric")
        x, nan = np.array([1.0, 2.0], np.float32), np.array([1.0, np.nan], np.float32)
        for _ in range(2):
            feed(jm, tm, x)
        feed(jm, tm, nan)
        assert engaged(tm)
        for m in (jm, tm):
            with pytest.warns(UserWarning, match="Will be removed. \\(surfaced asynchronously"):
                value = m.compute()
        assert_same(tm.compute(), jm.compute())
        assert float(value) == 7.0

    def test_cat_aggregator_nan_filtering_stays_eager(self):
        jm, tm = pair("CatMetric", nan_strategy="ignore")
        x = np.array([1.0, np.nan, 3.0], np.float32)
        for _ in range(3):
            feed(jm, tm, x)
        assert tm._auto_disabled and jm._auto_disabled
        out = tm.compute()
        assert out.shape == (6,) and not torch.isnan(out).any()

    def test_float_imputation_aggregator_compiles(self):
        jm, tm = pair("SumMetric", nan_strategy=0.0)
        x = np.array([1.0, np.nan, 3.0], np.float32)
        for _ in range(3):
            feed(jm, tm, x)
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        assert_same(tm.compute(), jm.compute())

    def test_list_state_metric_stays_eager(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5, multidim_average="samplewise", average="micro",
                      validate_args=False)
        rng = _rng(20)
        p, t = rng.random((4, 5, 6)).astype(np.float32), rng.integers(0, 5, (4, 6))
        for _ in range(3):
            feed(jm, tm, p, t)
        assert tm._auto_disabled and jm._auto_disabled
        assert "append-mode list" in tm._auto_disabled_reason
        assert len(tm.tp) == len(jm.tp) == 3

    def test_shape_churn_keeps_correctness(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5, validate_args=False)
        rng = _rng(21)
        cap = tm._AUTO_MAX_SIGNATURES
        assert cap == jm._AUTO_MAX_SIGNATURES == 8
        for i in range(2 * cap + 4):
            b = 8 + (i % (cap + 2))
            feed(jm, tm, rng.random((b, 5)).astype(np.float32), rng.integers(0, 5, b))
        assert len(tm._auto_sigs) == cap and len(tm.__dict__["_auto_update_fn"]) == cap
        assert_same(tm.compute(), jm.compute())

    def test_update_count_and_reset(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5, validate_args=False)
        p, t = _batches(1, seed=22)[0]
        for _ in range(4):
            feed(jm, tm, p, t)
        assert tm._update_count == jm._update_count == 4
        tm.reset()
        jm.reset()
        assert tm._update_count == 0
        feed(jm, tm, p, t)  # the compiled step still serves the signature after reset
        assert tm._update_count == 1
        assert_same(tm.compute(), jm.compute())

    def test_pickle_and_clone_drop_caches(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5, validate_args=False)
        p, t = (torch.from_numpy(a) for a in _batches(1, seed=23)[0])
        tm.update(p, t)
        tm.update(p, t)
        assert "_auto_update_fn" in tm.__dict__
        m2 = pickle.loads(pickle.dumps(tm))
        assert "_auto_update_fn" not in m2.__dict__ and m2._auto_sigs == {}
        c = tm.clone()
        assert "_auto_update_fn" not in c.__dict__ and c._auto_sigs == {}
        m2.update(p, t)
        tm.update(p, t)
        assert torch.equal(m2.tp, tm.tp)

    def test_set_dtype_invalidates_compiled_policy(self):
        jm, tm = pair("MeanSquaredError")
        rng = _rng(24)
        p, t = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
        feed(jm, tm, p, t)
        feed(jm, tm, p, t)
        jm.set_dtype(jnp.bfloat16)
        assert tm.set_dtype(torch.bfloat16) is tm
        feed(jm, tm, p, t)
        assert tm.sum_squared_error.dtype == torch.bfloat16 and jm.sum_squared_error.dtype == jnp.bfloat16
        assert len(tm.__dict__["_auto_update_fn"]) == 2  # one step per dtype policy
        feed(jm, tm, p, t)
        assert_same(tm.compute().float(), jm.compute().astype(jnp.float32), rtol=1e-2)

    @pytest.mark.parametrize("num_classes", [5, 300])
    def test_confusion_matrix_parity(self, num_classes):
        """Below 256 classes the step counts with ``index_add_`` (bincount reads back), from 256 through B1's plain version."""
        jm, tm = pair("MulticlassConfusionMatrix", num_classes=num_classes, validate_args=False)
        eager = TM.MulticlassConfusionMatrix(num_classes=num_classes, validate_args=False, device="cpu",
                                             auto_compile=False)
        for p, t in _batches(c=num_classes, seed=25):
            feed(jm, tm, p, t)
            eager.update(torch.from_numpy(p), torch.from_numpy(t))
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        assert torch.equal(tm.compute(), eager.compute())
        np.testing.assert_array_equal(tm.compute().numpy(), np.asarray(jm.compute()))

    def test_merge_state_after_auto_updates(self):
        a, b = (TM.MulticlassAccuracy(num_classes=5, validate_args=False, device="cpu") for _ in range(2))
        batches = _batches(4, seed=26)
        for p, t in batches[:2]:
            a.update(torch.from_numpy(p), torch.from_numpy(t))
        for p, t in batches[2:]:
            b.update(torch.from_numpy(p), torch.from_numpy(t))
        a.merge_state(b)
        ref = JM.MulticlassAccuracy(num_classes=5, validate_args=False, auto_compile=False)
        for p, t in batches:
            ref.update(jnp.asarray(p), jnp.asarray(t))
        assert_same(a.compute(), ref.compute())
        a.update(*(torch.from_numpy(x) for x in batches[0]))  # the step reads the merged states
        ref.update(*(jnp.asarray(x) for x in batches[0]))
        assert_same(a.compute(), ref.compute())


class TestRingBufferOverflowWarning:
    def test_compiled_stream_still_warns(self):
        jm, tm = pair("CatMetric", nan_strategy="disable", cat_state_capacity=8)
        x = np.arange(4, dtype=np.float32)
        for m in (jm, tm):
            arg = jnp.asarray(x) if m is jm else torch.from_numpy(x)
            with pytest.warns(UserWarning, match="capacity"):
                for _ in range(4):  # 16 rows > capacity 8
                    m.jit_update(arg)
        assert tm.value.count == jm.value._host_count == 16
        assert_same(tm.value.values(), jm.value.values(), rtol=0)

    def test_auto_compiled_stream_warns(self):
        jm, tm = pair("CatMetric", nan_strategy="disable", cat_state_capacity=8)
        x = np.arange(4, dtype=np.float32)
        for m in (jm, tm):
            arg = jnp.asarray(x) if m is jm else torch.from_numpy(x)
            with pytest.warns(UserWarning, match="capacity"):
                for _ in range(5):
                    m.update(arg)
        assert engaged(tm) and "_auto_update_fn" in jm.__dict__
        assert tm.value.count == jm.value._host_count == 20
        assert_same(tm.value.values(), jm.value.values(), rtol=0)

    def test_ring_state_after_reset_and_eager_updates(self):
        """The device cursor follows the host count across ``reset`` and updates of another signature."""
        tm = TM.CatMetric(nan_strategy="disable", cat_state_capacity=10, device="cpu")
        eager = TM.CatMetric(nan_strategy="disable", cat_state_capacity=10, device="cpu", auto_compile=False)
        rng = _rng(27)
        for step in range(12):
            if step == 6:
                tm.reset()
                eager.reset()
            x = torch.from_numpy(rng.random(3 if step % 4 else 2).astype(np.float32))
            tm.update(x)
            eager.update(x)
            assert tm.value.count == eager.value.count
            assert torch.equal(tm.value.values(), eager.value.values())
        assert engaged(tm)


class TestExplicitEntryPoints:
    def test_precompile_warms_and_leaves_the_metric_as_it_was(self):
        jm, tm = pair("MulticlassAccuracy", num_classes=5)
        p, t = _batches(1, seed=28)[0]
        feed(jm, tm, p, t)
        before = {n: getattr(tm, n).clone() for n in tm._defaults}
        rj = jm.precompile(jnp.asarray(p), jnp.asarray(t))
        rt = tm.precompile(torch.from_numpy(p), torch.from_numpy(t))
        assert rt == rj == {"engaged": True, "reason": None}
        assert tm.update_count == jm.update_count == 1
        assert all(torch.equal(getattr(tm, n), before[n]) for n in tm._defaults)
        feed(jm, tm, p, t)  # the first real update of the signature replays
        assert_states_equal(jm, tm)

    def test_precompile_reports_why_not(self):
        _, tm = pair("MulticlassAccuracy", num_classes=5, auto_compile=False)
        assert tm.precompile(*(torch.from_numpy(a) for a in _batches(1)[0])) == {
            "engaged": False, "reason": "auto path disabled for this instance"}
        # FID is certified metadata-only: it compiles by default in both packages, its trunk inside the step
        imgs = _rng(30).integers(0, 256, (6, 3, 4, 4)).astype(np.uint8)
        reports = [pkg.image.FrechetInceptionDistance(feature=_FirstPixels(), **kw).precompile(to(imgs), real=True)
                   for pkg, to, kw in ((JM, jnp.asarray, {}), (TM, torch.from_numpy, {"device": "cpu"}))]
        assert reports[0] == reports[1] == {"engaged": True, "reason": None}

    def test_collection_precompile_and_set_dtype(self):
        cols = [cls({"mse": mse(**kw), "mae": mae(**kw)})
                for cls, mse, mae, kw in ((JM.MetricCollection, JM.MeanSquaredError, JM.MeanAbsoluteError, {}),
                                          (TM.MetricCollection, TM.MeanSquaredError, TM.MeanAbsoluteError,
                                           {"device": "cpu"}))]
        rng = _rng(29)
        p, t = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
        reports = [c.precompile(jnp.asarray(p), jnp.asarray(t)) if i == 0 else
                   c.precompile(torch.from_numpy(p), torch.from_numpy(t)) for i, c in enumerate(cols)]
        assert reports[0] == reports[1] == {"mse": {"engaged": True, "reason": None},
                                            "mae": {"engaged": True, "reason": None}}
        assert cols[1].set_dtype(torch.float64) is cols[1]
        cols[1].update(torch.from_numpy(p), torch.from_numpy(t))
        assert cols[1]["mse"].sum_squared_error.dtype == torch.float64

    @pytest.mark.parametrize("name", ["MulticlassConfusionMatrix", "MeanSquaredError"])
    def test_jit_and_scan_update_match_eager(self, name):
        kwargs = {"num_classes": 5} if name == "MulticlassConfusionMatrix" else {}
        jm, tm = pair(name, **kwargs)
        scanned = getattr(TM, name)(device="cpu", **kwargs)
        eager = getattr(TM, name)(device="cpu", auto_compile=False, **kwargs)
        rng = _rng(30)
        if kwargs:
            xs, ys = rng.random((6, 32, 5)).astype(np.float32), rng.integers(0, 5, (6, 32))
        else:
            xs, ys = rng.standard_normal((6, 32)).astype(np.float32), rng.standard_normal((6, 32)).astype(np.float32)
        for x, y in zip(xs, ys):
            feed(jm, tm, x, y, method="jit_update")
            eager.update(torch.from_numpy(x), torch.from_numpy(y))
        scanned.scan_update(torch.from_numpy(xs), torch.from_numpy(ys))
        jscan = getattr(JM, name)(**kwargs)
        jscan.scan_update(jnp.asarray(xs), jnp.asarray(ys))
        for m in (tm, scanned):
            assert m.update_count == 6
            for n in m._defaults:
                assert torch.equal(getattr(m, n), getattr(eager, n)), n
        assert_states_equal(jscan, scanned)
        assert_same(scanned.compute(), jscan.compute())

    def test_jit_update_never_falls_back(self):
        _, tm = pair("MulticlassAccuracy", num_classes=5, multidim_average="samplewise")
        with pytest.raises(TM.utilities.exceptions.TorchMetricsUserError, match="append-mode list"):
            tm.jit_update(torch.rand(2, 5, 3), torch.randint(0, 5, (2, 3)))

    def test_jit_update_of_a_nan_error_aggregator_refuses(self):
        """With no fused flags a NaN batch can neither raise nor be dropped: the step refuses, as in the JAX package."""
        jm, tm = pair("SumMetric", nan_strategy="error")
        with pytest.raises(JM.utilities.exceptions.TorchMetricsUserError, match="fused violation flags"):
            jm.jit_update(jnp.ones(3))
        with pytest.raises(TM.utilities.exceptions.TorchMetricsUserError, match="fused violation flags"):
            tm.jit_update(torch.ones(3))


def test_reset_raises_a_pending_violation_after_resetting():
    jm, tm = pair("BinaryStatScores")
    rng = _rng(31)
    p, t = rng.random(8).astype(np.float32), rng.integers(0, 2, 8)
    for _ in range(2):
        feed(jm, tm, p, t)
    feed(jm, tm, p, np.full(8, 5))
    for m in (jm, tm):
        with pytest.raises(RuntimeError, match="raised asynchronously"):
            m.reset()
        assert m.update_count == 0
    assert int(tm.tp) == 0
    feed(jm, tm, p, t)
    assert_same(tm.compute(), jm.compute())


def test_compute_groups_replay_the_head_and_rebind_the_members():
    """The group's head alone runs its step; the members read the head's states, as eager."""

    def make(**kw):
        return TM.MetricCollection({
            "cm": TM.MulticlassConfusionMatrix(num_classes=5, device="cpu", **kw),
            "jac": TM.MulticlassJaccardIndex(num_classes=5, device="cpu", **kw),
            "acc": TM.MulticlassAccuracy(num_classes=5, device="cpu", **kw)})

    auto, eager = make(), make(auto_compile=False)
    for i, (p, t) in enumerate(_batches(7, seed=32)):
        args = (torch.from_numpy(p), torch.from_numpy(t))
        if i in (3, 4):  # an eager forward, then a compiled one, mid-stream
            got, want = auto(*args), eager(*args)
            assert_same(got, {k: v.numpy() for k, v in want.items()}, rtol=0)
        else:
            auto.update(*args)
            eager.update(*args)
    assert auto.compute_groups == eager.compute_groups == {0: ["acc"], 1: ["cm", "jac"]}
    assert engaged(auto["cm"]) and engaged(auto["jac"], "_auto_forward_fn")
    for name in ("cm", "jac", "acc"):
        assert auto[name].update_count == eager[name].update_count
        for n in auto[name]._defaults:
            assert torch.equal(getattr(auto[name], n), getattr(eager[name], n)), (name, n)
    assert_same(auto.compute(), {k: v.numpy() for k, v in eager.compute().items()}, rtol=0)


def test_the_step_flag_skips_the_host_reads():
    """Inside a step the host-reading checks do not run; the device flag vector carries them, as the JAX one."""
    import importlib

    ss = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")
    jss = importlib.import_module("torchmetrics_tpu.functional.classification.stat_scores")
    p, t = torch.zeros(4, 3), torch.tensor([0, 1, 2, 9])
    with pytest.raises(RuntimeError, match="Detected more unique values"):
        ss._multiclass_stat_scores_tensor_validation(p, t, 3)
    with _compiled_step():
        ss._multiclass_stat_scores_tensor_validation(p, t, 3)
    for preds in (p, torch.tensor([0, 1, 5, 2])):
        msgs, flags = ss._multiclass_stat_scores_value_flags(preds, t, 3)
        jmsgs, jflags = jss._multiclass_stat_scores_value_flags(jnp.asarray(preds.numpy()), jnp.asarray(t.numpy()), 3)
        assert msgs == jmsgs and flags.tolist() == np.asarray(jflags).tolist()


@pytest.mark.parametrize("wrap", ["multioutput", "minmax", "running"])
def test_wrappers_stay_eager_and_their_members_compile(wrap):
    """A wrapper's update acts on its member metrics (held in module containers): it refuses, they compile."""
    from torchmetrics_tpu_torch.wrappers import MinMaxMetric, MultioutputWrapper, Running

    def make(**kw):
        if wrap == "multioutput":
            return MultioutputWrapper(TM.R2Score(device="cpu", **kw), 3)
        if wrap == "minmax":
            return MinMaxMetric(TM.MeanSquaredError(device="cpu", **kw))
        return Running(TM.MeanSquaredError(device="cpu", **kw), window=2)

    auto, eager = make(), make(auto_compile=False)
    rng = _rng(33)
    for _ in range(4):
        x, y = rng.standard_normal((16, 3)).astype(np.float32), rng.standard_normal((16, 3)).astype(np.float32)
        if wrap != "multioutput":
            x, y = x[:, 0].copy(), y[:, 0].copy()
        for m in (auto, eager):
            m.update(torch.from_numpy(x), torch.from_numpy(y))
    assert auto._auto_disabled and "delegates to child metric" in auto._auto_disabled_reason
    assert_same(auto.compute(), {k: v.numpy() for k, v in eager.compute().items()} if wrap == "minmax"
                else eager.compute().numpy(), rtol=0)
    if wrap == "multioutput":
        assert all(engaged(m) for m in auto.metrics)


def test_launch_counter_counts_eager_launches_on_the_host_and_captured_ones_in_the_graph(monkeypatch):
    """A hit during a capture is an add on the device counter (run by each replay), never a host increment."""
    from torchmetrics_tpu_torch._kernels.launch_counter import LaunchCounter

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    dev = torch.device("cpu")
    counter = LaunchCounter()
    capturing[0] = True
    with pytest.raises(RuntimeError, match="first launch"):
        counter.hit(dev)  # nothing to record into before an eager launch made the device counter
    capturing[0] = False
    counter.hit(dev)
    counter.hit(dev)
    assert int(counter) == 2 and counter._host == 2
    capturing[0] = True
    counter.hit(dev)  # on the CPU the recorded add runs at once, as one replay would
    assert counter._host == 2 and int(counter) == 3
    counter.reset()
    assert int(counter) == 0
