"""Aggregators and ``Running`` of the port against the JAX package, on the CPU.

Seeded numpy batches, some with NaNs, stream through both packages' Sum, Mean,
Max, Min and Cat metrics under every ``nan_strategy`` (the JAX side with
``auto_compile=False``: its eager form, the one the port carries). Batch values
and ``compute`` agree within ``rtol=1e-6`` (float32 sums of a few terms in
another order). The values are positive, like the per-batch losses these
metrics usually average: a relative tolerance holds only for sums without
cancellation.

``RunningMean``, ``RunningSum`` and ``Running(MulticlassAccuracy)`` are held to
the JAX windows the same way.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as JA
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu.wrappers as JW
import torchmetrics_tpu_torch.aggregation as TA
import torchmetrics_tpu_torch.classification as TC
import torchmetrics_tpu_torch.wrappers as TW

from tests.test_torch_classification import C, multiclass_inputs

RTOL = 1e-6
STRATEGIES = ["warn", "ignore", "disable", 0.0, 2.5]
NAMES = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric"]


def assert_close(got, want):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape, (got, want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0, equal_nan=True)


def batches(seed, with_nan=True):
    """Five batches of 6 positive values; the second and fourth hold NaNs."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(5):
        x = rng.lognormal(size=6).astype(np.float32)
        if with_nan and b in (1, 3):
            x[rng.integers(0, 6, 2)] = np.nan
        out.append(x)
    return out


def pair(name, **kwargs):
    return getattr(JA, name)(auto_compile=False, **kwargs), getattr(TA, name)(device="cpu", **kwargs)


@pytest.mark.parametrize("nan_strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_stream_every_nan_strategy(name, nan_strategy):
    jm, tm = pair(name, nan_strategy=nan_strategy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b, x in enumerate(batches(1)):
            if b % 2 == 0:
                assert_close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
            else:
                jm.update(jnp.asarray(x))
                tm.update(torch.from_numpy(x))
        assert_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", NAMES)
def test_error_strategy_raises_on_nan(name):
    # eager against eager: the repeated signature raises at once (compiled, it surfaces at compute())
    jm, _ = pair(name, nan_strategy="error")
    tm = getattr(TA, name)(device="cpu", nan_strategy="error", auto_compile=False)
    clean, dirty = batches(2)[0], batches(2)[1]
    tm.update(torch.from_numpy(clean))
    jm.update(jnp.asarray(clean))
    for metric, x in ((jm, jnp.asarray(dirty)), (tm, torch.from_numpy(dirty))):
        with pytest.raises(RuntimeError, match="Encountered `nan`"):
            metric.update(x)
    assert_close(tm.compute(), jm.compute())


def test_warn_strategy_warns():
    _, tm = pair("SumMetric")
    with pytest.warns(UserWarning, match="Will be removed"):
        tm.update(torch.tensor([1.0, float("nan")]))
    assert float(tm.compute()) == 1.0


@pytest.mark.parametrize("weight_kind", ["scalar", "tensor"])
@pytest.mark.parametrize("nan_strategy", ["ignore", 0.0, 3.0], ids=str)
def test_mean_weights_and_the_scalar_weight_quirk(nan_strategy, weight_kind):
    """A float strategy with a scalar weight on a NaN batch sets every weight to that float (JAX ``aggregation.py:147-158``)."""
    jm, tm = pair("MeanMetric", nan_strategy=nan_strategy)
    rng = np.random.default_rng(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x in batches(3):
            w = np.float32(1.5) if weight_kind == "scalar" else rng.random(6).astype(np.float32)
            jm.update(jnp.asarray(x), jnp.asarray(w))
            tm.update(torch.from_numpy(x), torch.from_numpy(np.asarray(w)))
            assert_close(tm.value, jm.value)
            assert_close(tm.weight, jm.weight)
    assert_close(tm.compute(), jm.compute())


def test_scalar_weight_quirk_zeroes_a_nan_batch():
    """``nan_strategy=0.0``, a scalar weight and a NaN: every weight of the batch is 0, so the mean is 0 / 0."""
    jm, tm = pair("MeanMetric", nan_strategy=0.0)
    jm.update(jnp.array([1.0, jnp.nan]), 2.0)
    tm.update(torch.tensor([1.0, float("nan")]), 2.0)
    assert float(tm.weight) == float(jm.weight) == 0.0
    assert torch.isnan(tm.compute()) and bool(jnp.isnan(jm.compute()))


def test_scalar_and_empty_updates():
    for name in ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric"):
        jm, tm = pair(name)
        for v in (1.0, 4.0, -2.0):
            jm.update(v)
            tm.update(v)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm.update(jnp.array([jnp.nan]))  # dropped whole: an empty update
            tm.update(torch.tensor([float("nan")]))
        assert_close(tm.compute(), jm.compute())
    _, empty = pair("CatMetric")
    assert empty.compute() == []


@pytest.mark.parametrize("window", [1, 3, 5])
@pytest.mark.parametrize("name", ["RunningMean", "RunningSum"])
def test_running_aggregators(name, window):
    jm = getattr(JA, name)(window=window, nan_strategy="ignore", auto_compile=False)
    tm = getattr(TA, name)(window=window, nan_strategy="ignore", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b, x in enumerate(batches(4) + batches(5)):
            if b % 3 == 0:
                assert_close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
            else:
                jm.update(jnp.asarray(x))
                tm.update(torch.from_numpy(x))
            assert_close(tm.compute(), jm.compute())
    tm.reset()
    assert tm._slots == [] and tm.base_metric.update_count == 0


def test_running_classification_metric():
    jm = JW.Running(JC.MulticlassAccuracy(num_classes=C, auto_compile=False), window=2)
    tm = TW.Running(TC.MulticlassAccuracy(num_classes=C, device="cpu"), window=2)
    for b in range(5):
        arrays = multiclass_inputs(60 + b)
        j_args, t_args = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
        if b % 2:
            assert_close(tm(*t_args), jm(*j_args))
        else:
            jm.update(*j_args)
            tm.update(*t_args)
        assert_close(tm.compute(), jm.compute())
    assert tm.base_metric.update_count == 0  # the wrapped metric itself stays untouched


def test_running_refuses_full_state_metrics_and_bad_windows():
    with pytest.raises(ValueError, match="full_state_update"):
        TW.Running(TA.MaxMetric(device="cpu"))
    with pytest.raises(ValueError, match="window"):
        TW.Running(TA.SumMetric(device="cpu"), window=0)
    with pytest.raises(ValueError, match="instance of `Metric`"):
        TW.Running(object())
    with pytest.raises(ValueError, match="nan_strategy"):
        TA.SumMetric(nan_strategy="drop", device="cpu")
