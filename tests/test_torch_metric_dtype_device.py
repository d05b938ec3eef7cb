"""``Metric``'s dtype and device surface against the JAX package's.

In the JAX package ``type``/``float``/``double``/``half`` return the metric
unchanged (``torchmetrics_tpu/metric.py:2560-2570``) and ``set_dtype`` is
the only cast; ``dtype`` reports the ``set_dtype`` policy, else the first
floating state's dtype, else float32 (``:2549``); ``to_device`` moves every
state (``:2501``, ``collections.py:498``). The port's nn.Module casts and
``.to(<dtype>)`` go through ``Metric._apply``, which moves devices and never
casts. The streamed values are held to the JAX package's at 1e-6 relative
(float32 sums of the same numpy values).
"""

import inspect

import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P

RTOL = 1e-6


def _stream(seed=0, n_updates=100, size=1000):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 10, size).astype(np.float32), rng.uniform(0, 10, size).astype(np.float32))
            for _ in range(n_updates)]


def _jax_mse(batches, cast=None):
    import jax.numpy as jnp

    m = J.regression.MeanSquaredError()
    if cast is not None:
        assert cast(m) is m
    for p, t in batches:
        m.update(jnp.asarray(p), jnp.asarray(t))
    return float(m.compute())


def _port_mse(batches, cast):
    m = P.regression.MeanSquaredError(device="cpu")
    moved = cast(m)
    assert moved is m
    for p, t in batches:
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    assert all(v.dtype == torch.float32 for v in m.metric_state.values() if v.is_floating_point())
    return float(m.compute()), m


def test_metric_device_dtype_properties():
    """Counterpart of ``tests/unittests/test_signature_parity.py:85``."""
    m = P.classification.MulticlassAccuracy(num_classes=3, device="cpu")
    assert m.device == torch.device("cpu")
    assert m.dtype == torch.float32
    assert m.type(torch.float16) is m  # a no-op, as in the JAX package
    m.set_dtype(torch.bfloat16)
    assert m.dtype == torch.bfloat16


def test_half_stream_matches_the_jax_package():
    """``.half()`` used to cast the float32 sums to float16, which overflowed to ``inf``."""
    batches = _stream()
    want = _jax_mse(batches, cast=lambda m: m.half())
    assert want == pytest.approx(16.575, rel=1e-4)
    got, m = _port_mse(batches, lambda m: m.half())
    assert np.isfinite(got) and got == pytest.approx(want, rel=RTOL)
    assert m.dtype == torch.float32


@pytest.mark.parametrize(
    "cast",
    [
        lambda m: m.double(),
        lambda m: m.float(),
        lambda m: m.bfloat16(),
        lambda m: m.type(torch.float16),
        lambda m: m.to(torch.float16),
        lambda m: m.to("cpu", torch.float64),
        lambda m: m.to(dtype=torch.bfloat16),
    ],
    ids=["double", "float", "bfloat16", "type_float16", "to_float16", "to_cpu_float64", "to_dtype_bfloat16"],
)
def test_casts_leave_the_state_dtypes(cast):
    batches = _stream(seed=1, n_updates=10)
    got, m = _port_mse(batches, cast)
    assert got == pytest.approx(_jax_mse(batches), rel=RTOL)
    assert all(d.dtype == torch.float32 for d in m._defaults.values() if d.is_floating_point())


def test_casts_leave_integer_and_ring_states():
    m = P.classification.MulticlassConfusionMatrix(num_classes=4, device="cpu")
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 3]))
    before = m.confmat.clone()
    assert m.to(torch.float16) is m and m.half() is m
    assert m.confmat.dtype == before.dtype and torch.equal(m.confmat, before)
    cat = P.aggregation.CatMetric(device="cpu", cat_state_capacity=4)
    cat.update(torch.arange(3.0))
    cat.to(torch.float64)
    assert cat.value.data.dtype == torch.float32 and cat.compute().dtype == torch.float32


def test_lpips_half_leaves_its_network_float32():
    with pytest.warns(UserWarning, match="random weights"):
        m = P.image.LearnedPerceptualImagePatchSimilarity(net_type="alex", device="cpu")
    dtypes = {p.dtype for p in m.parameters()}
    assert m.half() is m and m.to(torch.float16) is m
    assert {p.dtype for p in m.parameters()} == dtypes == {torch.float32}


def test_a_move_keeps_the_trunks_channels_last_layout():
    with pytest.warns(UserWarning, match="random weights"):
        m = P.image.LearnedPerceptualImagePatchSimilarity(net_type="alex", device="cpu")
    convs = [p for p in m.parameters() if p.dim() == 4]
    assert convs and all(p.is_contiguous(memory_format=torch.channels_last) for p in convs)
    m.to("cpu")
    assert all(p.is_contiguous(memory_format=torch.channels_last) for p in m.parameters() if p.dim() == 4)
    m.to(memory_format=torch.contiguous_format)
    assert all(p.is_contiguous() for p in m.parameters() if p.dim() == 4)
    m.to(memory_format=torch.channels_last)
    assert all(p.is_contiguous(memory_format=torch.channels_last) for p in m.parameters() if p.dim() == 4)
    assert {p.dtype for p in m.parameters()} == {torch.float32}


def test_set_dtype_still_casts():
    m = P.regression.MeanSquaredError(device="cpu")
    m.set_dtype(torch.bfloat16)
    assert m.dtype == torch.bfloat16 and m.sum_squared_error.dtype == torch.bfloat16
    m.update(torch.ones(4), torch.zeros(4))
    assert m.sum_squared_error.dtype == torch.bfloat16
    m.half()  # a no-op: the policy stays
    assert m.dtype == torch.bfloat16


def test_dtype_is_the_first_floating_state_then_float32():
    m = P.regression.MeanSquaredError(device="cpu")
    m.sum_squared_error = m.sum_squared_error.double()  # a state rebound by hand
    assert m.dtype == torch.float64
    assert P.classification.MulticlassConfusionMatrix(num_classes=3, device="cpu").dtype == torch.float32


def test_to_device_returns_self_and_moves_every_state():
    m = P.aggregation.CatMetric(device="cpu")
    m.update(torch.arange(3.0))
    ring = P.aggregation.CatMetric(device="cpu", cat_state_capacity=4)
    ring.update(torch.arange(2.0))
    for metric in (m, ring, P.regression.MeanSquaredError(device="cpu")):
        assert metric.to_device("cpu") is metric
        assert metric.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for v in m.value)
    assert ring.value.device == torch.device("cpu") and ring.value.data.device.type == "cpu"


def test_collection_casts_are_no_ops_and_to_device_returns_self():
    batches = _stream(seed=2, n_updates=10)
    mc = P.MetricCollection({"mse": P.regression.MeanSquaredError(device="cpu"),
                             "mae": P.regression.MeanAbsoluteError(device="cpu")})
    for cast in (lambda c: c.half(), lambda c: c.double(), lambda c: c.bfloat16(), lambda c: c.float(),
                 lambda c: c.type(torch.float16), lambda c: c.to(torch.float16), lambda c: c.to_device("cpu")):
        assert cast(mc) is mc
    for p, t in batches:
        mc.update(torch.from_numpy(p), torch.from_numpy(t))
    import jax.numpy as jnp

    jc = J.MetricCollection({"mse": J.regression.MeanSquaredError(), "mae": J.regression.MeanAbsoluteError()})
    assert jc.to_device(__import__("jax").devices("cpu")[0]) is jc
    for p, t in batches:
        jc.update(jnp.asarray(p), jnp.asarray(t))
    got, want = mc.compute(), jc.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=RTOL)
    assert all(v.dtype == torch.float32 for m in mc.values() for v in m.metric_state.values() if v.is_floating_point())
    mc.set_dtype(torch.float64)
    assert all(m.dtype == torch.float64 for m in mc.values())


def test_dtype_and_to_device_exist_where_the_jax_package_has_them():
    names = [n for n in J.__all__ if inspect.isclass(getattr(J, n, None)) and inspect.isclass(getattr(P, n, None))]
    assert len(names) == 218
    for attr in ("dtype", "to_device"):
        jax_has = {n for n in names if hasattr(getattr(J, n), attr)}
        port_has = {n for n in names if hasattr(getattr(P, n), attr)}
        assert port_has == jax_has, (attr, sorted(port_has ^ jax_has))
    assert len({n for n in names if hasattr(getattr(J, n), "dtype")}) == 216  # all but the two collections
    for attr in ("type", "float", "double", "half"):
        for n in names:
            if hasattr(getattr(J, n), attr):
                assert getattr(getattr(P, n), attr) is not torch.nn.Module.__dict__[attr], (n, attr)
