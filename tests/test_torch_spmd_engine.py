"""The SPMD engine at 8 CPU rows against the eager stream and against the JAX engine at 8 CPU devices.

From ``tests/unittests/spmd/test_engine.py`` and the non-degrading cases of
``test_groups.py``: the same seeded numpy batches go through the port's
engine on a mesh of 8 rows on the CPU (``build_mesh(devices=["cpu"] * 8)``),
through an eager port metric, and through the JAX engine on the 8 CPU
devices of ``tests/conftest.py``, for a metric, a collection with compute
groups, a ring state, replica groups and Pearson's gathered moments. Counts
must be equal; floats within ``RTOL`` of the eager stream and of the JAX
engine (the sync sums 8 rows' partial sums in another order than one
accumulator).

The JAX engine donates its state buffers; the port's rows are updated in
place and ``donate=`` is refused: the counterparts of the two donation tests
check exactly that.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as TM
from torchmetrics_tpu.metric import Metric as JaxMetric
from torchmetrics_tpu_torch._spmd import InGraphSyncUnsupported, SpmdEngine, build_mesh
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

WORLD = 8
B = 8 * WORLD
C = 4
RTOL, ATOL = 1e-6, 1e-7
MESH = build_mesh(devices=["cpu"] * WORLD)
RNG = np.random.default_rng(7)
GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7]]


def _batch(rows=B):
    return RNG.random((rows, C)).astype(np.float32), RNG.integers(0, C, rows)


def _port(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _agree(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(got.dtype, np.floating) or np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


def _quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args)


def test_fused_step_matches_eager_stream_and_the_jax_engine():
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    eager = TM.MulticlassAccuracy(num_classes=C, device="cpu", auto_compile=False)
    jeng = jtm.MulticlassAccuracy(num_classes=C).to_spmd()
    for i in range(4):
        p, t = _batch()
        fused = eng.step(*_port(p, t))
        eager.update(*_port(p, t))
        want = eager.compute()
        eager._computed = None
        _agree(fused, want, f"step {i} vs eager")
        _agree(fused, jeng.step(*_jax(p, t)), f"step {i} vs the JAX engine")
    _agree(eng.compute(), want, "compute")
    assert eng.steps == 4 and not eng.degraded


def test_rows_are_updated_in_place():
    """The counterpart of the JAX donation test: a step writes the same row tensors, no copy."""
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    eng.step(*_port(*_batch()))
    pre = [(s, s.data_ptr(), s.clone()) for s in eng._states[""].values()]
    eng.step(*_port(*_batch()))
    post = list(eng._states[""].values())
    assert all(a is b and a.data_ptr() == ptr for (a, ptr, _), b in zip(pre, post))
    assert any(not torch.equal(a, old) for a, _, old in pre)
    assert all(s.shape[0] == WORLD for s in post)


def test_donate_is_refused():
    """The counterpart of the JAX ``donate=False`` test: the rows are always the step's own buffers."""
    with pytest.raises(TypeError, match="donate"):
        TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH, donate=False)


def test_collection_compute_groups_share_one_step():
    def make(pkg, **kw):
        return pkg.MetricCollection([pkg.MulticlassAccuracy(num_classes=C, **kw), pkg.MulticlassPrecision(num_classes=C, **kw)])

    eng = make(TM, device="cpu").to_spmd(mesh=MESH)
    jeng = make(jtm).to_spmd()
    eager = make(TM, device="cpu", auto_compile=False)
    for _ in range(3):
        p, t = _batch()
        fused = eng.step(*_port(p, t))
        jfused = _quiet(jeng.step, *_jax(p, t))
        _quiet(eager.update, *_port(p, t))
    # the step formed ONE compute group (shared stat-score states)
    assert len(eng._units) == 1
    assert sorted(eng.target._groups[0]) == ["MulticlassAccuracy", "MulticlassPrecision"]
    want = eager.compute()
    assert set(fused) == set(want) == set(jfused)
    for key in want:
        _agree(fused[key], want[key], key)
        _agree(fused[key], jfused[key], f"{key} vs the JAX engine")


def test_confusion_matrix_through_the_kernel_route_bit_for_bit():
    """300 classes take B1's route (its plain version on the CPU) under vmap, adding into the rows."""
    c = 300
    eng = TM.MulticlassConfusionMatrix(num_classes=c, device="cpu").to_spmd(mesh=MESH)
    rows = [TM.MulticlassConfusionMatrix(num_classes=c, device="cpu", auto_compile=False) for _ in range(WORLD)]
    whole = TM.MulticlassConfusionMatrix(num_classes=c, device="cpu", auto_compile=False)
    for _ in range(2):
        p, t = RNG.integers(0, c, 2 * B), RNG.integers(0, c, 2 * B)
        fused = eng.step(*_port(p, t))
        whole.update(*_port(p, t))
        for d, m in enumerate(rows):
            m.update(*_port(p[d * 16:(d + 1) * 16], t[d * 16:(d + 1) * 16]))
    assert torch.equal(fused, whole.compute()) and fused.dtype == whole.compute().dtype == torch.int32
    assert all(torch.equal(eng._states[""]["confmat"][d], m.confmat) for d, m in enumerate(rows))


class _PortCatMean(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(cat_state_capacity=B * 8, device="cpu")
        self.add_state("vals", default=[], dist_reduce_fx="cat")

    def update(self, x):
        self.vals.append(x)

    def compute(self):
        data, valid = self.vals.masked()
        return torch.where(valid, data, 0.0).sum() / valid.sum()


class _JaxCatMean(JaxMetric):
    full_state_update = False

    def __init__(self):
        super().__init__(cat_state_capacity=B * 8)
        self.add_state("vals", default=[], dist_reduce_fx="cat")

    def update(self, x):
        self.vals.append(x)

    def compute(self):
        data, valid = self.vals.masked()
        return jnp.sum(jnp.where(valid, data, 0.0)) / jnp.sum(valid)


def test_ring_cat_state_all_gathers():
    eng = _PortCatMean().to_spmd(mesh=MESH, enforce_manifest=False)
    jeng = _JaxCatMean().to_spmd(enforce_manifest=False)
    chunks = []
    for _ in range(3):
        x = RNG.random(B).astype(np.float32)
        chunks.append(x)
        fused = eng.step(*_port(x))
        jfused = jeng.step(*_jax(x))
    want = float(np.mean(np.concatenate(chunks)))
    assert abs(float(fused) - want) < 1e-5
    _agree(fused, jfused, "ring vs the JAX engine", rtol=1e-6)
    ring = eng._states[""]["vals"]
    assert ring["data"].shape == (WORLD, B * 8) and ring["count"].tolist() == [3 * 8] * WORLD


def test_fresh_metric_required():
    m = TM.MulticlassAccuracy(num_classes=C, device="cpu")
    m.update(*_port(*_batch()))
    with pytest.raises(Exception, match="fresh metric"):
        m.to_spmd(mesh=MESH)


def test_batch_must_divide_mesh():
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    with pytest.raises(TorchMetricsUserError, match="divisible"):
        eng.step(*_port(*_batch(WORLD + 1)))


def test_reset_restores_defaults():
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    p, t = _port(*_batch())
    v1 = eng.step(p, t)
    eng.reset()
    assert eng.steps == 0
    _agree(eng.step(p, t), v1, "after reset")


def test_engine_rejects_non_metric():
    with pytest.raises(Exception, match="Metric or MetricCollection"):
        SpmdEngine(object(), mesh=MESH)


def test_telemetry_path_spmd_counters():
    from torchmetrics_tpu_torch._observability import set_telemetry_enabled

    set_telemetry_enabled(True)
    try:
        m = TM.MulticlassAccuracy(num_classes=C, device="cpu")
        eng = m.to_spmd(mesh=MESH)
        for _ in range(3):
            eng.step(*_port(*_batch()))
        report = m.telemetry_report()
        assert report.counters.get("update_calls|path=spmd") == 3
        assert report.counters.get("compiles|kind=spmd_step") == 1
        from torchmetrics_tpu_torch._observability.telemetry import telemetry_for

        gauge = telemetry_for(m).gauges.get("predicted_state_bytes|scope=spmd_device")
        assert gauge == eng.predicted_device_bytes() > 0
    finally:
        set_telemetry_enabled(False)


def test_spmd_step_span_and_ledger_seam():
    """One ``spmd.step`` span a step, and the ledger's ``spmd_step`` seam timing every step but the build."""
    from torchmetrics_tpu_torch._observability import REGISTRY, set_profiling_enabled
    from torchmetrics_tpu_torch._observability.profiling import LEDGER, reset_ledger
    from torchmetrics_tpu_torch._observability.tracing import TRACER, set_tracing_enabled, span_tree, trace_context

    reset_ledger()
    TRACER.clear()
    set_tracing_enabled(True)
    set_profiling_enabled(True)
    try:
        eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
        with trace_context("eval") as root:
            for _ in range(3):
                eng.step(*_port(*_batch()))
        (tree,) = span_tree(root.trace_id)
        assert [c["name"] for c in tree["children"]] == ["spmd.step"] * 3
        snap = LEDGER.snapshot()
        row = next(r for r in snap["seams"] if r["seam"] == "spmd_step")
        assert row["steps"] == 2  # the first step is the build, counted apart
        assert [rec["kind"] for rec in snap["executables"].values()] == ["spmd_step"]
    finally:
        set_tracing_enabled(False)
        set_profiling_enabled(False)
        TRACER.clear()
        reset_ledger()
        REGISTRY.reset()


def test_warm_start_builds_without_consuming_a_batch():
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    plain = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    p, t = _port(*_batch())
    assert eng.warm_start(p, t) == {"spmd_step": "compiled", "spmd_compute": "ready"}
    assert eng.warm_start(p, t) == {"spmd_step": "ready", "spmd_compute": "ready"}
    assert eng.steps == 0 and all(int(s.abs().sum()) == 0 for s in eng._states[""].values())
    p2, t2 = _port(*_batch())
    assert torch.equal(eng.step(p2, t2), plain.step(p2, t2))


def test_sync_to_target_folds_the_rows_and_keeps_streaming():
    eng = TM.MulticlassConfusionMatrix(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    eager = TM.MulticlassConfusionMatrix(num_classes=C, device="cpu", auto_compile=False)
    for _ in range(2):
        p, t = _port(*_batch())
        eng.step(p, t)
        eager.update(p, t)
    assert torch.equal(eng.sync_to_target().compute(), eager.compute())
    assert eng.target.update_count == 2 * WORLD and not eng.degraded


# -------------------------------------------------- replica groups (test_groups.py)
def _regression_batch():
    return RNG.standard_normal(B).astype(np.float32), RNG.standard_normal(B).astype(np.float32)


def _group_rows(g):
    return np.concatenate([np.arange(d * 8, (d + 1) * 8) for d in g])


def test_grouped_step_returns_one_value_per_replica():
    """Each group syncs on its own: group g's value equals an eager metric fed that group's shards, and the JAX engine's."""
    eng = TM.MeanSquaredError(device="cpu").to_spmd(mesh=MESH, groups=GROUPS)
    jeng = jtm.MeanSquaredError().to_spmd(groups=GROUPS)
    eagers = [TM.MeanSquaredError(device="cpu", auto_compile=False) for _ in GROUPS]
    for _ in range(3):
        p, t = _regression_batch()
        out = eng.step(*_port(p, t))
        jout = jeng.step(*_jax(p, t))
        assert set(out) == set(jout) == {0, 1}
        for gi, g in enumerate(GROUPS):
            eagers[gi].update(*_port(p[_group_rows(g)], t[_group_rows(g)]))
            _agree(out[gi], jout[gi], f"group {gi} vs the JAX engine")
    assert not eng.degraded
    for gi in range(len(GROUPS)):
        _agree(out[gi], eagers[gi].compute(), f"group {gi}", rtol=1e-5)
    again = eng.compute()
    for gi in range(len(GROUPS)):
        _agree(again[gi], out[gi], f"group {gi} compute")


def test_grouped_pearson_gathers_within_the_group():
    eng = TM.PearsonCorrCoef(device="cpu").to_spmd(mesh=MESH, groups=GROUPS)
    jeng = jtm.PearsonCorrCoef().to_spmd(groups=GROUPS)
    eagers = [TM.PearsonCorrCoef(device="cpu") for _ in GROUPS]
    for _ in range(2):
        p, t = _regression_batch()
        out = eng.step(*_port(p, t))
        jout = jeng.step(*_jax(p, t))
        for gi, g in enumerate(GROUPS):
            eagers[gi].update(*_port(p[_group_rows(g)], t[_group_rows(g)]))
    assert not eng.degraded
    for gi in range(len(GROUPS)):
        _agree(out[gi], eagers[gi].compute(), f"group {gi}", rtol=1e-4, atol=1e-6)
        _agree(out[gi], jout[gi], f"group {gi} vs the JAX engine", rtol=1e-4, atol=1e-6)


def test_bad_group_partitions_rejected():
    with pytest.raises(InGraphSyncUnsupported, match="partitioning"):
        TM.MeanSquaredError(device="cpu").to_spmd(mesh=MESH, groups=[[0, 1], [2]])
    with pytest.raises(InGraphSyncUnsupported, match="partitioning"):
        TM.MeanSquaredError(device="cpu").to_spmd(mesh=MESH, groups=[list(range(WORLD)), list(range(WORLD))])


def test_pearson_gathered_moments_match_eager_and_the_jax_engine():
    """Pearson's dist_reduce_fx=None moments gather as (D, num_outputs) sets that its compute folds in the step."""
    eng = TM.PearsonCorrCoef(device="cpu").to_spmd(mesh=MESH)
    jeng = jtm.PearsonCorrCoef().to_spmd()
    eager = TM.PearsonCorrCoef(device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = rng.standard_normal(64).astype(np.float32)
        y = (0.5 * x + rng.standard_normal(64)).astype(np.float32)
        fused = eng.step(*_port(x, y))
        jfused = jeng.step(*_jax(x, y))
        eager.update(*_port(x, y))
    assert not eng.degraded
    _agree(fused, eager.compute(), "vs eager", rtol=1e-4, atol=1e-6)
    _agree(fused, jfused, "vs the JAX engine", rtol=1e-4, atol=1e-6)
