"""The SPMD engine's degradation contract: a faulted step folds the rows into the host metric and goes eager.

From ``tests/unittests/spmd/test_degradation.py``, the degradation and
handshake cases of ``test_groups.py`` and the Pearson fold of
``test_specs.py``, on a mesh of 8 rows on the CPU. The degraded streams are
held to an eager metric fed the same batches, and the first two to the JAX
engine's degraded stream as well (counts equal, floats within ``RTOL``).
Added for the port: a compute that reads a host value (``vmap`` refuses it,
as ``jit`` refuses it in the JAX package) degrades with the JAX wording, and
a fault once the step has begun writing the rows in place, the counterpart
of a failed step that consumed its donated buffers, restarts from the
defaults. The JAX test models that fault by deleting the donated buffers;
here the fault is a compute that fails on its second step, after the rows
were written.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as TM
from torchmetrics_tpu._spmd import faultinject as jax_faultinject
from torchmetrics_tpu_torch._spmd import build_mesh, faultinject
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

WORLD = 8
B = 8 * WORLD
C = 4
RTOL = 1e-6
MESH = build_mesh(devices=["cpu"] * WORLD)
RNG = np.random.default_rng(21)
GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7]]


def _batch():
    return RNG.random((B, C)).astype(np.float32), RNG.integers(0, C, B)


def _port(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args)


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=1e-7, err_msg=what)


def test_injected_failure_degrades_and_stream_continues():
    m = TM.MulticlassAccuracy(num_classes=C, device="cpu")
    eng = m.to_spmd(mesh=MESH)
    jeng = jtm.MulticlassAccuracy(num_classes=C).to_spmd()
    eager = TM.MulticlassAccuracy(num_classes=C, device="cpu", auto_compile=False)
    batches = [_batch() for _ in range(4)]
    eng.step(*_port(*batches[0]))
    jeng.step(*_jax(*batches[0]))
    eager.update(*_port(*batches[0]))
    with faultinject.inject_step_failure():
        v = _quiet(eng.step, *_port(*batches[1]))
    with jax_faultinject.inject_step_failure():
        jv = _quiet(jeng.step, *_jax(*batches[1]))
    eager.update(*_port(*batches[1]))
    assert eng.degraded and jeng.degraded
    # the failed batch was NOT lost: the degraded step ran it eagerly
    want = eager.compute()
    eager._computed = None
    _close(v, want, "degraded step")
    _close(v, jv, "degraded step vs the JAX engine")
    for p, t in batches[2:]:
        v = _quiet(eng.step, *_port(p, t))
        jv = _quiet(jeng.step, *_jax(p, t))
        eager.update(*_port(p, t))
        want = eager.compute()
        eager._computed = None
        _close(v, want, "eager continuation")
        _close(v, jv, "eager continuation vs the JAX engine")
    assert eng.steps == jeng.steps == 4


def test_degradation_recorded_in_resilience_report():
    m = TM.MulticlassAccuracy(num_classes=C, device="cpu")
    eng = m.to_spmd(mesh=MESH)
    eng.step(*_port(*_batch()))
    with faultinject.inject_step_failure():
        _quiet(eng.step, *_port(*_batch()))
    events = m.resilience_report().events
    assert any(e.kind == "spmd_degraded" for e in events)
    assert any("eager guarded sync" in e.detail and "fused step failed: RuntimeError" in e.detail for e in events)


class Kinds(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("s_sum", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("s_max", default=torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("s_min", default=torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("s_mean", default=torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.s_sum = self.s_sum + x.sum()
        self.s_max = torch.maximum(self.s_max, x.max())
        self.s_min = torch.minimum(self.s_min, x.min())
        self.s_mean = self.s_mean + x.mean()

    def compute(self):
        return torch.stack([self.s_sum, self.s_max, self.s_min, self.s_mean])


def test_fold_preserves_every_reduction_kind():
    """The fold merges the rows with each state's OWN reduction: sum/max/min against the eager stream, mean exactly."""
    eng = Kinds().to_spmd(mesh=MESH, enforce_manifest=False)
    eager = Kinds()
    xs = [RNG.random(B).astype(np.float32) for _ in range(3)]
    for x in xs[:2]:
        eng.step(*_port(x))
        eager.update(*_port(x))
    rows = eng._states[""]["s_mean"].clone()
    with faultinject.inject_step_failure():
        v = _quiet(eng.step, *_port(xs[2]))
    eager.update(*_port(xs[2]))
    _close(v[:3], eager.compute()[:3], "sum/max/min", rtol=1e-5)
    # the mean state folded to the rows' mean, then took the eager update
    _close(v[3], float(rows.mean()) + float(xs[2].mean()), "mean", rtol=1e-6)


def test_collection_degradation_rebinds_members():
    def make(pkg, **kw):
        return pkg.MetricCollection([pkg.MulticlassAccuracy(num_classes=C, **kw), pkg.MulticlassPrecision(num_classes=C, **kw)])

    eng = make(TM, device="cpu").to_spmd(mesh=MESH)
    jeng = make(jtm).to_spmd()
    eager = make(TM, device="cpu", auto_compile=False)
    b1, b2 = _batch(), _batch()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.step(*_port(*b1))
        jeng.step(*_jax(*b1))
        eager.update(*_port(*b1))
        with faultinject.inject_step_failure():
            v = eng.step(*_port(*b2))
        with jax_faultinject.inject_step_failure():
            jv = jeng.step(*_jax(*b2))
        eager.update(*_port(*b2))
        want = eager.compute()
    assert eng.degraded
    for key in want:
        _close(v[key], want[key], key)
        _close(v[key], jv[key], f"{key} vs the JAX engine")


def test_programming_errors_raise_instead_of_degrading():
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    eng.step(*_port(*_batch()))
    with faultinject.inject_step_failure(exc_factory=lambda: TypeError("bug")):
        with pytest.raises(TypeError, match="bug"):
            eng.step(*_port(*_batch()))
    assert not eng.degraded


def test_bounded_injection_recovers():
    """A single-shot fault degrades THIS engine; a fresh engine on a healthy seam takes the fused path again."""
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    eng.step(*_port(*_batch()))
    with faultinject.inject_step_failure(times=1):
        _quiet(eng.step, *_port(*_batch()))
        assert eng.degraded
        eng2 = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
        eng2.step(*_port(*_batch()))  # injection exhausted: fused path healthy
        assert not eng2.degraded


class FailsOnSecondCompute(Metric):
    """Sums; its compute raises a runtime fault from its second call on (a lost card, say)."""

    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        self.calls = 0

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("backend died mid-execution")
        return self.total


def test_fault_after_the_rows_were_written_restarts_without_crash():
    """The counterpart of the JAX post-donation fault: the rows were written in place, so nothing can fold.

    Degradation must still land on a working eager stream, restarted from
    the defaults with the loss recorded, never a crash.
    """
    m = FailsOnSecondCompute()
    eng = m.to_spmd(mesh=MESH, enforce_manifest=False)
    x1, x2 = RNG.random(B).astype(np.float32), RNG.random(B).astype(np.float32)
    eng.step(*_port(x1))
    v = _quiet(eng.step, *_port(x2))
    assert eng.degraded
    events = m.resilience_report().events
    assert any("restarts from defaults" in e.detail and "writing the rows in place" in e.detail for e in events)
    # the eager stream restarted: the degraded step's value is a 1-batch value
    _close(v, float(x2.sum()), "restarted stream", rtol=1e-5)
    assert eng.steps == 1


class ReadsAHostValue(Metric):
    """Sums; its compute branches on a host value, as FID's does (``image/fid.py``)."""

    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("n", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()
        self.n = self.n + x.numel()

    def compute(self):
        if int(self.n) < 2:
            raise ValueError("needs two samples")
        return self.total / self.n


def test_host_reading_compute_degrades_as_in_the_jax_engine():
    """``vmap`` refuses the host read, even with one group: the first step folds (nothing was kept) and goes eager."""
    m = ReadsAHostValue()
    eng = m.to_spmd(mesh=MESH, enforce_manifest=False)
    x = RNG.random(B).astype(np.float32)
    v = _quiet(eng.step, *_port(x))
    assert eng.degraded and eng.steps == 1
    _close(v, float(x.mean()), "eager value", rtol=1e-5)
    detail = m.resilience_report().events[-1].detail
    assert detail.startswith("fused step does not trace: RuntimeError") and "restarts" not in detail


def test_no_batch_arrays_is_user_error():
    eng = TM.MulticlassAccuracy(num_classes=C, device="cpu").to_spmd(mesh=MESH)
    with pytest.raises(TorchMetricsUserError, match="array argument"):
        eng.step()


def test_pearson_degrade_folds_gathered_moments():
    """A fault mid-stream folds Pearson's gathered (D, num_outputs) moment sets into ONE local set."""
    eng = TM.PearsonCorrCoef(device="cpu").to_spmd(mesh=MESH)
    eager = TM.PearsonCorrCoef(device="cpu")
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    eng.step(*_port(x, y))
    eager.update(*_port(x, y))
    with faultinject.inject_step_failure(times=1):
        _quiet(eng.step, *_port(x + 1, y))
    eager.update(*_port(x + 1, y))
    assert eng.degraded
    assert eng.target.mean_x.ndim == 1  # folded states are local-form, not stacked
    _close(eng.target.compute(), eager.compute(), "pearson", rtol=1e-4)


# ----------------------------------------------------- groups (test_groups.py)
def _regression_batch():
    return RNG.standard_normal(B).astype(np.float32), RNG.standard_normal(B).astype(np.float32)


def test_grouped_degradation_folds_home_group():
    """The fold merges the HOME replica group only (the host target is one stream), and says so."""
    eng = TM.MeanSquaredError(device="cpu").to_spmd(mesh=MESH, groups=GROUPS)
    home_eager = TM.MeanSquaredError(device="cpu")
    p, t = _regression_batch()
    eng.step(*_port(p, t))
    home = np.concatenate([np.arange(d * 8, (d + 1) * 8) for d in GROUPS[0]])
    home_eager.update(*_port(p[home], t[home]))
    with faultinject.inject_step_failure():
        _quiet(eng.step, *_port(p, t))
    assert eng.degraded
    events = eng.target.resilience_report().events
    assert any(e.kind == "spmd_degraded" and "home replica group" in e.detail for e in events)
    # the fold carried the home group's accumulation; the failed batch ran eagerly on the FULL batch
    home_eager.update(*_port(p, t))
    _close(eng.target.compute(), home_eager.compute(), "home group", rtol=1e-5)


def test_group_mismatched_handshake_degrades():
    """A handshake transport fault before the first step never builds it: the eager path owns the whole stream."""
    from torchmetrics_tpu_torch._resilience import faultinject as eager_fi
    from torchmetrics_tpu_torch._resilience.policy import RetryPolicy, SyncPolicy

    m = TM.MeanSquaredError(device="cpu", sync_policy=SyncPolicy(handshake=True, retry=RetryPolicy(max_retries=1, backoff_base=0.0)))
    eng = m.to_spmd(mesh=MESH, groups=GROUPS)
    p, t = _regression_batch()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with eager_fi.simulated_world(2), eager_fi.inject_collective_failure(first_n=8):
            out = eng.step(*_port(p, t))
    assert eng.degraded and eng._units is None
    assert any("trace-time structure handshake degraded" in e.detail for e in m.resilience_report().events)
    eager = TM.MeanSquaredError(device="cpu")
    eager.update(*_port(p, t))
    _close(out, eager.compute(), "eager stream")
