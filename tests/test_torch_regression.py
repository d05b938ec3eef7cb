"""The port's regression metrics on the CPU, against the JAX package.

All 19 functionals and all 19 classes take the same seeded numpy inputs in
both packages: 1-D and multi-output data, the classes half by ``forward``
and half by ``update`` over ragged batches, then ``compute``, a
``state_dict`` round trip, ``merge_state`` of two halves and ``reset``.
Float results agree within ``RTOL``/``ATOL``: float32 sums of up to ~100
terms taken in another order. Counts (CSI's hits, misses and false alarms,
the sample counts) are equal.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.regression as JF
import torchmetrics_tpu.regression as JR
import torchmetrics_tpu_torch.functional.regression as PF
import torchmetrics_tpu_torch.regression as PR

RTOL = 1e-5
ATOL = 1e-6
BATCHES = (29, 17, 31, 8)


def make(kind, seed, n=41):
    """Seeded (preds, target) of one input kind, float32."""
    rng = np.random.default_rng(seed)
    if kind == "normal1":
        p, t = rng.normal(size=n) * 2, rng.normal(size=n) * 2
    elif kind == "normal3":
        t = rng.normal(size=(n, 3)) * 2
        p = t + rng.normal(size=(n, 3))
    elif kind == "positive1":
        p, t = rng.uniform(0.1, 5, n), rng.uniform(0.1, 5, n)
    elif kind == "zero_inflated":  # claim counts: mostly zero
        p = rng.uniform(0.05, 3, n)
        t = np.where(rng.random(n) < 0.7, 0.0, rng.gamma(2.0, 1.0, n))
    elif kind == "unit3d":  # (sequence, H, W) frames for CSI
        t = rng.uniform(0, 1, (n, 4, 5))
        p = np.clip(t + rng.normal(0, 0.2, (n, 4, 5)), 0, 1)
    elif kind == "dist":
        p, t = rng.uniform(0.05, 1, (n, 5)), rng.uniform(0.05, 1, (n, 5))
    elif kind == "logdist":
        p, t = rng.normal(size=(n, 5)), rng.normal(size=(n, 5))
        p, t = p - np.log(np.exp(p).sum(1, keepdims=True)), t - np.log(np.exp(t).sum(1, keepdims=True))
    elif kind == "rows":
        p, t = rng.normal(size=(n, 6)), rng.normal(size=(n, 6))
    elif kind == "ties":  # gold scores on a 0-5 grid in steps of 0.2, predictions on a coarse grid
        t = rng.integers(0, 26, n) * 0.2
        p = np.round(t + rng.normal(0, 1, n), 1)
    else:
        raise ValueError(kind)
    return p.astype(np.float32), t.astype(np.float32)


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, rtol, atol)
        return
    assert isinstance(got, torch.Tensor)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def both(fn_name, preds, target, **kwargs):
    got = getattr(PF, fn_name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = getattr(JF, fn_name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    return got, want


FUNCTIONAL = [
    ("mean_squared_error", {}, "normal1"),
    ("mean_squared_error", {"squared": False}, "normal1"),
    ("mean_squared_error", {"num_outputs": 3}, "normal3"),
    ("mean_absolute_error", {}, "normal1"),
    ("mean_absolute_error", {"num_outputs": 3}, "normal3"),
    ("mean_squared_log_error", {}, "positive1"),
    ("log_cosh_error", {}, "normal1"),
    ("log_cosh_error", {}, "normal3"),
    ("mean_absolute_percentage_error", {}, "normal1"),
    ("symmetric_mean_absolute_percentage_error", {}, "normal1"),
    ("weighted_mean_absolute_percentage_error", {}, "normal3"),
    ("minkowski_distance", {"p": 1}, "normal1"),
    ("minkowski_distance", {"p": 3.5}, "normal3"),
    ("critical_success_index", {"threshold": 0.5}, "unit3d"),
    ("critical_success_index", {"threshold": 0.5, "keep_sequence_dim": True}, "unit3d"),
    ("critical_success_index", {"threshold": 0.3, "keep_sequence_dim": True}, "positive1"),
    ("tweedie_deviance_score", {"power": 0}, "normal1"),
    ("tweedie_deviance_score", {"power": 1}, "zero_inflated"),
    ("tweedie_deviance_score", {"power": 1.5}, "zero_inflated"),
    ("tweedie_deviance_score", {"power": 2}, "positive1"),
    ("tweedie_deviance_score", {"power": 3}, "positive1"),
    ("tweedie_deviance_score", {"power": -1}, "positive1"),
    *[("kl_divergence", {"log_prob": False, "reduction": r}, "dist") for r in ("mean", "sum", "none", None)],
    *[("kl_divergence", {"log_prob": True, "reduction": r}, "logdist") for r in ("mean", "sum", "none", None)],
    *[("cosine_similarity", {"reduction": r}, "rows") for r in ("sum", "mean", "none", None)],
    ("explained_variance", {}, "normal1"),
    *[("explained_variance", {"multioutput": m}, "normal3") for m in ("raw_values", "uniform_average", "variance_weighted")],
    ("r2_score", {}, "normal1"),
    ("r2_score", {"adjusted": 3}, "normal1"),
    *[("r2_score", {"multioutput": m}, "normal3") for m in ("raw_values", "uniform_average", "variance_weighted")],
    ("r2_score", {"adjusted": 2, "multioutput": "raw_values"}, "normal3"),
    ("relative_squared_error", {}, "normal1"),
    ("relative_squared_error", {"squared": False}, "normal3"),
    ("pearson_corrcoef", {}, "normal1"),
    ("pearson_corrcoef", {}, "normal3"),
    ("concordance_corrcoef", {}, "normal1"),
    ("concordance_corrcoef", {}, "normal3"),
    ("spearman_corrcoef", {}, "ties"),
    ("spearman_corrcoef", {}, "normal3"),
    ("kendall_rank_corrcoef", {}, "ties"),
    ("kendall_rank_corrcoef", {"variant": "c", "t_test": True}, "normal3"),
]


@pytest.mark.parametrize(("seed", "fn_name", "kwargs", "kind"), [(i, *case) for i, case in enumerate(FUNCTIONAL)],
                         ids=[f"{f}-{k}-{i}" for i, (f, _, k) in enumerate(FUNCTIONAL)])
def test_functional_matches_jax(seed, fn_name, kwargs, kind):
    p, t = make(kind, seed)
    got, want = both(fn_name, p, t, **kwargs)
    assert_close(got, want)


def test_all_19_functionals_are_covered():
    assert sorted({f for f, _, _ in FUNCTIONAL}) == sorted(PF.__all__) and len(PF.__all__) == 19


def test_csi_counts_are_exact():
    """Hits, misses and false alarms: int64 in the port, equal to the JAX package's int32 counts."""
    fn = __import__("torchmetrics_tpu_torch.functional.regression.csi", fromlist=["x"])
    jfn = __import__("torchmetrics_tpu.functional.regression.csi", fromlist=["x"])
    p, t = make("unit3d", 3, n=64)
    for keep in (False, True):
        got = fn._critical_success_index_update(torch.from_numpy(p), torch.from_numpy(t), 0.5, keep)
        want = jfn._critical_success_index_update(jnp.asarray(p), jnp.asarray(t), 0.5, keep)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("preds_equal", [True, False])
def test_r2_constant_target_guards(preds_equal):
    """tss ~ 0 and rss ~ 0 gives 1.0, tss ~ 0 and rss > 0 gives 0.0, in both packages, never -inf or NaN."""
    t = np.full((12, 2), 1.5, np.float32)
    t[:, 1] = np.linspace(0, 1, 12)
    p = t.copy() if preds_equal else t + np.float32(0.25)
    got, want = both("r2_score", p, t, multioutput="raw_values")
    assert_close(got, want)
    assert float(got[0]) == (1.0 if preds_equal else 0.0)
    got, want = both("explained_variance", p, t, multioutput="raw_values")
    assert_close(got, want)


@pytest.mark.parametrize(("adjusted", "message"), [(40, "More independent regressions"), (11, "Division by zero")])
def test_r2_adjusted_fallbacks_warn(adjusted, message):
    p, t = make("normal1", 5, n=12)
    with pytest.warns(UserWarning, match=message):
        got = PF.r2_score(torch.from_numpy(p), torch.from_numpy(t), adjusted=adjusted)
    with pytest.warns(UserWarning, match=message):
        want = JF.r2_score(jnp.asarray(p), jnp.asarray(t), adjusted=adjusted)
    assert_close(got, want)
    assert_close(got, PF.r2_score(torch.from_numpy(p), torch.from_numpy(t)))


@pytest.mark.parametrize(("fn_name", "kwargs", "shape", "error"), [
    ("tweedie_deviance_score", {"power": 0.5}, (5,), "not defined for power"),
    ("r2_score", {}, (1,), "at least two samples"),
    ("r2_score", {"multioutput": "bad"}, (5,), "multioutput"),
    ("r2_score", {"adjusted": -1}, (5,), "adjusted"),
    ("explained_variance", {"multioutput": "bad"}, (5,), "multioutput"),
    ("minkowski_distance", {"p": 0.5}, (5,), "greater than 1"),
    ("kl_divergence", {}, (5,), "2D"),
    ("cosine_similarity", {}, (5,), "2D"),
    ("r2_score", {}, (5, 2, 2), "1D or 2D"),
    ("log_cosh_error", {}, (5, 2, 2), "1- or 2-dimensional"),
])
def test_functional_argument_errors(fn_name, kwargs, shape, error):
    x = np.ones(shape, np.float32)
    for fn, conv in ((getattr(PF, fn_name), torch.from_numpy), (getattr(JF, fn_name), jnp.asarray)):
        with pytest.raises(Exception, match=error):
            fn(conv(x), conv(x), **kwargs)


def test_shape_mismatch_raises():
    with pytest.raises(RuntimeError, match="same shape"):
        PF.mean_squared_error(torch.zeros(3), torch.zeros(4))


# ------------------------------------------------------------------ classes
CLASSES = [
    ("MeanSquaredError", {}, "normal1"),
    ("MeanSquaredError", {"squared": False, "num_outputs": 3}, "normal3"),
    ("MeanAbsoluteError", {"num_outputs": 3}, "normal3"),
    ("MeanSquaredLogError", {}, "positive1"),
    ("LogCoshError", {}, "normal1"),
    ("LogCoshError", {"num_outputs": 3}, "normal3"),
    ("MeanAbsolutePercentageError", {}, "normal1"),
    ("SymmetricMeanAbsolutePercentageError", {}, "normal3"),
    ("WeightedMeanAbsolutePercentageError", {}, "normal1"),
    ("MinkowskiDistance", {"p": 3}, "normal3"),
    ("CriticalSuccessIndex", {"threshold": 0.5}, "unit3d"),
    ("CriticalSuccessIndex", {"threshold": 0.5, "keep_sequence_dim": True}, "unit3d"),
    *[("TweedieDevianceScore", {"power": p}, k) for p, k in
      ((0, "normal1"), (1, "zero_inflated"), (1.5, "zero_inflated"), (2, "positive1"), (3, "positive1"))],
    ("KLDivergence", {}, "dist"),
    ("KLDivergence", {"log_prob": True, "reduction": "sum"}, "logdist"),
    ("KLDivergence", {"reduction": "none"}, "dist"),
    ("KLDivergence", {"log_prob": True, "reduction": None}, "logdist"),
    ("CosineSimilarity", {}, "rows"),
    ("CosineSimilarity", {"reduction": "mean"}, "rows"),
    ("CosineSimilarity", {"reduction": "none"}, "rows"),
    ("ExplainedVariance", {}, "normal1"),
    ("ExplainedVariance", {"multioutput": "raw_values"}, "normal3"),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, "normal3"),
    ("R2Score", {}, "normal1"),
    ("R2Score", {"adjusted": 2}, "normal1"),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, "normal3"),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted", "adjusted": 1}, "normal3"),
    ("RelativeSquaredError", {}, "normal1"),
    ("RelativeSquaredError", {"num_outputs": 3, "squared": False}, "normal3"),
    ("PearsonCorrCoef", {}, "normal1"),
    ("PearsonCorrCoef", {"num_outputs": 3}, "normal3"),
    ("ConcordanceCorrCoef", {}, "normal1"),
    ("ConcordanceCorrCoef", {"num_outputs": 3}, "normal3"),
    ("SpearmanCorrCoef", {}, "ties"),
    ("SpearmanCorrCoef", {"num_outputs": 3}, "normal3"),
    ("KendallRankCorrCoef", {}, "ties"),
    ("KendallRankCorrCoef", {"variant": "a", "t_test": True, "alternative": "less"}, "ties"),
]


def _batches(kind, seed):
    return [make(kind, seed + i, n) for i, n in enumerate(BATCHES)]


def _tensors(p, t):
    return torch.from_numpy(p), torch.from_numpy(t)


def stream_both(name, kwargs, batches):
    """Half ``forward``, half ``update`` through both packages; the batch values of ``forward`` must agree."""
    pm = getattr(PR, name)(**kwargs, device="cpu")
    jm = getattr(JR, name)(**kwargs, auto_compile=False)
    for i, (p, t) in enumerate(batches):
        if i % 2 == 0:
            got, want = pm(*_tensors(p, t)), jm(jnp.asarray(p), jnp.asarray(t))
            assert_close(got, want)
        else:
            pm.update(*_tensors(p, t))
            jm.update(jnp.asarray(p), jnp.asarray(t))
    return pm, jm


@pytest.mark.parametrize(("name", "kwargs", "kind"), CLASSES, ids=[f"{c}-{i}" for i, (c, _, _) in enumerate(CLASSES)])
def test_class_matches_jax(name, kwargs, kind):
    batches = _batches(kind, 100 + len(name))
    pm, jm = stream_both(name, kwargs, batches)
    want = jm.compute()
    assert_close(pm.compute(), want)

    # the states round-trip through state_dict
    fresh = getattr(PR, name)(**kwargs, device="cpu")
    fresh.load_state_dict(pm.state_dict(all_states=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # `compute` before `update` warns
        assert_close(fresh.compute(), want)

    # two halves merged give the whole stream
    first, second = (getattr(PR, name)(**kwargs, device="cpu") for _ in range(2))
    for p, t in batches[:2]:
        first.update(*_tensors(p, t))
    for p, t in batches[2:]:
        second.update(*_tensors(p, t))
    first.merge_state(second)
    assert_close(first.compute(), want)

    # reset: the first batch alone
    pm.reset()
    pm.update(*_tensors(*batches[0]))
    jalone = getattr(JR, name)(**kwargs, auto_compile=False)
    jalone.update(*(jnp.asarray(a) for a in batches[0]))
    assert_close(pm.compute(), jalone.compute())


def test_all_19_classes_are_covered():
    assert sorted({c for c, _, _ in CLASSES}) == sorted(PR.__all__) and len(PR.__all__) == 19


@pytest.mark.parametrize("name", sorted(PR.__all__))
def test_class_flags_equal_jax(name):
    p_cls, j_cls = getattr(PR, name), getattr(JR, name)
    for flag in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
        assert getattr(p_cls, flag) == getattr(j_cls, flag), flag


def test_count_states_keep_the_jax_dtypes():
    """float32 counts where the JAX package keeps float32; int64 where it keeps int32."""
    cases = {
        ("MeanAbsolutePercentageError", "total"): torch.float32,
        ("TweedieDevianceScore", "num_observations"): torch.float32,
        ("ExplainedVariance", "num_obs"): torch.float32,
        ("PearsonCorrCoef", "n_total"): torch.float32,
        ("MeanSquaredError", "total"): torch.int64,
        ("R2Score", "total"): torch.int64,
        ("KLDivergence", "total"): torch.int64,
    }
    for (name, state), dtype in cases.items():
        m = getattr(PR, name)(device="cpu")
        m.update(*_tensors(*make("dist" if name == "KLDivergence" else "positive1", 1)))
        assert getattr(m, state).dtype == dtype, (name, state)


@pytest.mark.parametrize(("name", "kwargs", "error"), [
    ("MeanSquaredError", {"squared": 1}, "boolean"),
    ("MeanSquaredError", {"num_outputs": 0}, "positive integer"),
    ("TweedieDevianceScore", {"power": 0.5}, "not defined"),
    ("MinkowskiDistance", {"p": 0.5}, "greater than 1"),
    ("KLDivergence", {"log_prob": 1}, "bool"),
    ("KLDivergence", {"reduction": "max"}, "reduction"),
    ("CosineSimilarity", {"reduction": "max"}, "reduction"),
    ("CriticalSuccessIndex", {"threshold": "x"}, "threshold"),
    ("R2Score", {"adjusted": -1}, "adjusted"),
    ("R2Score", {"multioutput": "x"}, "multioutput"),
    ("ExplainedVariance", {"multioutput": "x"}, "multioutput"),
    ("PearsonCorrCoef", {"num_outputs": 0}, "num_outputs"),
    ("KendallRankCorrCoef", {"variant": "d"}, "variant"),
    ("KendallRankCorrCoef", {"t_test": "yes"}, "t_test"),
])
def test_class_argument_errors(name, kwargs, error):
    with pytest.raises(Exception, match=error):
        getattr(PR, name)(**kwargs, device="cpu")
    with pytest.raises(Exception, match=error):
        getattr(JR, name)(**kwargs, auto_compile=False)


def test_classes_default_to_cuda(monkeypatch):
    """Built without ``device=``, a metric keeps its states on ``cuda``: where there is no GPU it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PR.MeanSquaredError()
