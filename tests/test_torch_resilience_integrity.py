"""The port's state integrity and NaN sentinel against the JAX package, on the CPU.

From ``tests/unittests/resilience/test_integrity.py`` and ``test_satellites.py``:
every test runs the same call sequence, on the same seeded numpy inputs,
through both packages (``JAX`` and ``PORT`` below) and compares what it
observes. The JAX metrics run with ``auto_compile=False`` where their eager
form is what the port's ``nan_policy`` pins. Added for the port:

- the in-place rollback: the port's updates write into their state tensors
  (``state += batch``, kernel B1's ``out=``), so a quarantine that kept the
  pre-update states by reference, as the JAX package may, would keep the
  poisoned batch; ``test_quarantine_rolls_back_in_place_updates`` fails then;
- integrity digests equal to the JAX package's for states of equal dtype, and
  checkpoints moved between the packages in both directions.

The other ``test_torch_resilience_*.py`` files import ``JAX``, ``PORT`` and the
helpers from here.
"""

import contextlib
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu._resilience as j_res
import torchmetrics_tpu._resilience.chaos as j_chaos
import torchmetrics_tpu._resilience.faultinject as j_fi
import torchmetrics_tpu._resilience.integrity as j_integrity
import torchmetrics_tpu._resilience.snapshot as j_snapshot
import torchmetrics_tpu.metric as j_metric
import torchmetrics_tpu.utilities.distributed as j_dist
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch._resilience as t_res
import torchmetrics_tpu_torch._resilience.chaos as t_chaos
import torchmetrics_tpu_torch._resilience.faultinject as t_fi
import torchmetrics_tpu_torch._resilience.integrity as t_integrity
import torchmetrics_tpu_torch._resilience.snapshot as t_snapshot
import torchmetrics_tpu_torch.metric as t_metric
import torchmetrics_tpu_torch.utilities.distributed as t_dist
from tests.helpers.testers import DummyListMetric as JaxDummyList
from tests.helpers.testers import DummySumMetric as JaxDummySum


class DummySumMetric(ttm.Metric):
    """The JAX suite's scalar sum dummy, updated in place as the port's metrics are."""

    full_state_update = False

    def __init__(self, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        self.add_state("x", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.x += torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def compute(self):
        return self.x


class DummyListMetric(ttm.Metric):
    """The JAX suite's append-mode dummy."""

    full_state_update = False

    def __init__(self, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        self.add_state("x", [], dist_reduce_fx="cat")

    def update(self, x):
        self.x.append(torch.as_tensor(x, dtype=torch.float32, device=self.device))

    def compute(self):
        return torch.cat(self.x)


def _side(is_jax: bool) -> types.SimpleNamespace:
    """One package behind one interface: its modules, array maker, host reader and constructor kwargs."""
    if is_jax:
        return types.SimpleNamespace(
            name="jax", tm=jtm, res=j_res, fi=j_fi, integrity=j_integrity, snapshot=j_snapshot, chaos=j_chaos,
            dist=j_dist, Metric=j_metric.Metric, DummySum=JaxDummySum, DummyList=JaxDummyList,
            kw={}, eager={"auto_compile": False}, arr=lambda a: jnp.asarray(np.asarray(a)),
        )
    return types.SimpleNamespace(
        name="port", tm=ttm, res=t_res, fi=t_fi, integrity=t_integrity, snapshot=t_snapshot, chaos=t_chaos,
        dist=t_dist, Metric=t_metric.Metric, DummySum=DummySumMetric, DummyList=DummyListMetric,
        kw={"device": "cpu"}, eager={"device": "cpu"}, arr=lambda a: torch.as_tensor(np.asarray(a)),
    )


JAX, PORT = _side(True), _side(False)


def host(x):
    """Numpy of an array, tensor or list of them (a state dict's value)."""
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def both(fn):
    """``fn(JAX)`` and ``fn(PORT)``, for a test to compare."""
    return fn(JAX), fn(PORT)


def close(a, b, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(host(a), dtype=np.float64), np.asarray(host(b), dtype=np.float64),
                               rtol=rtol, atol=atol)


@contextlib.contextmanager
def quiet():
    """Degradation warnings are the stack working as designed: silence them where a test does not read them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _persistent_sum(S, value=5.0):
    m = S.DummySum(**S.eager)
    m.persistent(True)
    m.update(value)
    return m


def _acc(S, **kw):
    return S.tm.classification.MulticlassAccuracy(num_classes=3, validate_args=False, **S.eager, **kw)


def _mse(S, **kw):
    return S.tm.MeanSquaredError(**S.eager, **kw)


# ------------------------------------------------------------ checkpoint integrity
def test_round_trip_with_integrity():
    def run(S):
        sd = _persistent_sum(S).state_dict(integrity=True)
        key = S.integrity.integrity_key()
        assert key in sd and sd[key]["version"] == S.res.INTEGRITY_VERSION
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        fresh.load_state_dict(sd)
        return float(host(fresh.x)), sd[key]

    (jv, jblock), (pv, pblock) = both(run)
    assert jv == pv == 5.0
    assert jblock == pblock  # same version, class, digests and finiteness


@pytest.mark.parametrize("mode", ["bitflip", "nan"])
def test_corruption_rejected(mode):
    """``test_bitflip_corruption_rejected`` and ``test_nan_poisoned_checkpoint_rejected``."""

    def run(S):
        bad = S.fi.corrupt_state_dict(_persistent_sum(S).state_dict(integrity=True), mode=mode)
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        with pytest.raises(S.res.StateCorruptionError, match="failed integrity verification") as err:
            fresh.load_state_dict(bad)
        assert float(host(fresh.x)) == 0.0
        return err.value.corrupted

    j, p = both(run)
    assert j == p and "x" in p
    if mode == "bitflip":
        assert "checksum mismatch" in p["x"]


def test_repair_resets_only_corrupted_states():
    def run(S):
        m = _acc(S)
        m.persistent(True)
        m.update(S.arr([0, 1, 2]), S.arr([0, 1, 1]))
        sd = m.state_dict(integrity=True)
        bad = S.fi.corrupt_state_dict(sd, key="tp", mode="bitflip")
        fresh = _acc(S)
        fresh.persistent(True)
        with quiet():
            fresh.load_state_dict(bad, strict="repair")
        report = fresh.resilience_report()
        assert [e.kind for e in report.events] == ["state_repair"] and "tp" in report.events[0].detail
        return host(fresh.tp), host(fresh.fp), host(sd["fp"])

    (jtp, jfp, jsd), (ptp, pfp, psd) = both(run)
    np.testing.assert_array_equal(ptp, np.zeros(3))
    np.testing.assert_array_equal(jtp, ptp)
    np.testing.assert_array_equal(pfp, psd)
    np.testing.assert_array_equal(jfp, pfp)


def test_unknown_schema_version_rejected():
    def run(S):
        sd = _persistent_sum(S).state_dict(integrity=True)
        key = S.integrity.integrity_key()
        sd[key] = dict(sd[key], version=S.res.INTEGRITY_VERSION + 1)
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        with pytest.raises(S.res.StateCorruptionError, match="schema version") as err:
            fresh.load_state_dict(sd)
        return str(err.value)

    j, p = both(run)
    assert j == p


def test_legacy_checkpoint_without_integrity_loads():
    def run(S):
        sd = _persistent_sum(S, 7.0).state_dict()
        assert S.integrity.integrity_key() not in sd
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        fresh.load_state_dict(sd)
        return float(host(fresh.x))

    assert both(run) == (7.0, 7.0)


def test_repair_screens_nan_in_legacy_checkpoint():
    def run(S):
        sd = _persistent_sum(S).state_dict()
        sd["x"] = np.asarray(np.nan, dtype=np.float32)
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        with quiet():
            fresh.load_state_dict(sd, strict="repair")
        return float(host(fresh.x)), fresh.resilience_report().events[0].kind

    assert both(run) == ((0.0, "state_repair"), (0.0, "state_repair"))


def test_list_state_round_trip():
    def run(S):
        m = S.DummyList(**S.eager)
        m.persistent(True)
        m.update(S.arr(np.float32([1.0, 2.0])))
        m.update(S.arr(np.float32([3.0])))
        sd = m.state_dict(integrity=True)
        fresh = S.DummyList(**S.eager)
        fresh.persistent(True)
        fresh.load_state_dict(sd)
        bad = S.fi.corrupt_state_dict(sd, mode="bitflip")
        fresh2 = S.DummyList(**S.eager)
        fresh2.persistent(True)
        with pytest.raises(S.res.StateCorruptionError):
            fresh2.load_state_dict(bad)
        return host(fresh.compute()), sd[S.integrity.integrity_key()]

    (jv, jb), (pv, pb) = both(run)
    np.testing.assert_allclose(pv, [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(jv, pv)
    assert jb == pb


def test_inf_sentinel_defaults_not_flagged():
    def run(S):
        m = S.tm.aggregation.MinMetric(**S.eager)
        m.persistent(True)
        sd = m.state_dict(integrity=True)
        fresh = S.tm.aggregation.MinMetric(**S.eager)
        fresh.persistent(True)
        fresh.load_state_dict(sd)  # no error despite the inf payload
        return bool(np.isinf(host(fresh.value)).all()), sd[S.integrity.integrity_key()]["states"]["value"]["finite"]

    assert both(run) == ((True, False), (True, False))


def _collection(S, names=("acc", "mse")):
    return S.tm.MetricCollection({names[0]: _acc(S), names[1]: _mse(S)})


def test_collection_integrity_round_trip_and_repair():
    def run(S):
        mc = _collection(S)
        mc.persistent(True)
        mc.update(S.arr([0, 1, 2]), S.arr([0, 1, 1]))
        sd = mc.state_dict(integrity=True)
        key = S.integrity.integrity_key
        assert key("acc.") in sd and key("mse.") in sd
        bad = S.fi.corrupt_state_dict(sd, key="mse.sum_squared_error", mode="bitflip")
        fresh = _collection(S)
        fresh.persistent(True)
        with pytest.raises(S.res.StateCorruptionError):
            fresh.load_state_dict(bad)
        with quiet():
            fresh.load_state_dict(bad, strict="repair")
        return float(host(fresh["mse"].sum_squared_error).sum()), host(fresh["acc"].tp), host(sd["acc.tp"])

    (j0, jtp, _), (p0, ptp, psd) = both(run)
    assert j0 == p0 == 0.0
    np.testing.assert_array_equal(ptp, psd)
    np.testing.assert_array_equal(jtp, ptp)


# ------------------------------------------------------------------- nan_policy
def test_raise_policy():
    def run(S):
        m = _mse(S, nan_policy="raise")
        m.update(S.arr(np.ones(4, np.float32)), S.arr(np.zeros(4, np.float32)))
        with pytest.raises(RuntimeError, match="Non-finite values detected") as err:
            m.update(S.fi.poison_nans(S.arr(np.ones(4, np.float32))), S.arr(np.zeros(4, np.float32)))
        return str(err.value)

    j, p = both(run)
    assert j == p


def test_warn_policy():
    def run(S):
        m = _mse(S, nan_policy="warn")
        with pytest.warns(UserWarning, match="Non-finite values detected"):
            m.update(S.fi.poison_nans(S.arr(np.ones(4, np.float32))), S.arr(np.zeros(4, np.float32)))
        return bool(np.isnan(host(m.compute())))  # warn does not roll back

    assert both(run) == (True, True)


def test_quarantine_drops_only_bad_batches():
    def run(S):
        q = _mse(S, nan_policy="quarantine")
        clean = _mse(S)
        p, t = S.arr(np.full(8, 2.0, np.float32)), S.arr(np.zeros(8, np.float32))
        with quiet(), S.fi.nan_batches(q, indices=(1,)) as stats:
            for _ in range(3):
                q.update(p, t)
        for _ in range(2):
            clean.update(p, t)
        report = q.resilience_report()
        return (stats.injected, q._update_count, float(host(q.compute())), float(host(clean.compute())),
                report.quarantined_updates, [e.kind for e in report.events])

    j, p = both(run)
    assert j == p == (1, 2, 4.0, 4.0, 1, ["nan_quarantine"])


def test_quarantine_cannot_recover_pre_poisoned_state():
    def run(S):
        m = _mse(S)  # no policy: the poison slips in
        m.update(S.fi.poison_nans(S.arr(np.ones(4, np.float32))), S.arr(np.zeros(4, np.float32)))
        m.set_resilience_policy(nan_policy="quarantine")
        with pytest.warns(UserWarning, match="already non-finite"):
            m.update(S.arr(np.ones(4, np.float32)), S.arr(np.zeros(4, np.float32)))
        return m.resilience_report().quarantined_updates

    assert both(run) == (0, 0)


def test_inf_default_states_exempt():
    def run(S):
        m = S.tm.aggregation.MinMetric(nan_policy="raise", **S.eager)
        m.update(S.arr(np.float32([3.0, 1.0])))
        return float(host(m.compute()))

    assert both(run) == (1.0, 1.0)


def test_invalid_policy_rejected():
    for S in (JAX, PORT):
        with pytest.raises(ValueError, match="nan_policy"):
            _mse(S, nan_policy="explode")
        with pytest.raises(ValueError, match="sync_policy"):
            _mse(S, sync_policy="not-a-policy")


def _mean_state_cls(S):
    xp = jnp if S is JAX else torch

    class MeanState(S.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("avg", xp.zeros(()), dist_reduce_fx="mean")

        def update(self, x):
            self.avg = xp.mean(xp.asarray(x))

        def compute(self):
            return self.avg

    return MeanState


def test_quarantine_forward_does_not_contaminate_mean_state():
    def run(S):
        cls = _mean_state_cls(S)
        q, clean = cls(nan_policy="quarantine", **S.eager), cls(**S.eager)
        with quiet():
            q(S.arr(np.float32([2.0, 4.0])))
            clean(S.arr(np.float32([2.0, 4.0])))
            q(S.fi.poison_nans(S.arr(np.float32([8.0, 8.0]))))
            q(S.arr(np.float32([6.0, 8.0])))
            clean(S.arr(np.float32([6.0, 8.0])))
        return (float(host(q.compute())), float(host(clean.compute())), q._update_count, clean._update_count,
                q.resilience_report().quarantined_updates)

    assert both(run) == ((5.0, 5.0, 2, 2, 1), (5.0, 5.0, 2, 2, 1))


def test_repair_resets_missing_persistent_key_without_integrity():
    def run(S):
        sd = _persistent_sum(S, 5.0).state_dict()
        del sd["x"]
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        with pytest.raises(KeyError):
            fresh.load_state_dict(sd)  # strict=True keeps raising
        with quiet():
            fresh.load_state_dict(sd, strict="repair")
        return float(host(fresh.x)), "x" in fresh.resilience_report().events[0].detail

    assert both(run) == ((0.0, True), (0.0, True))


def test_raise_policy_in_forward_preserves_accumulation():
    def run(S):
        m = _mse(S, nan_policy="raise")
        p, t = S.arr(np.full(4, 2.0, np.float32)), S.arr(np.zeros(4, np.float32))
        for _ in range(3):
            m(p, t)
        with pytest.raises(RuntimeError, match="Non-finite"):
            m(S.fi.poison_nans(S.arr(np.ones(4, np.float32))), t)
        out = (m._update_count, float(host(m.compute())))
        m(p, t)
        return out + (m._update_count,)

    assert both(run) == ((3, 4.0, 4), (3, 4.0, 4))


def test_set_resilience_policy_rejected_leaves_state_unchanged():
    for S in (JAX, PORT):
        m = _mse(S)
        with pytest.raises(ValueError, match="sync_policy"):
            m.set_resilience_policy(sync_policy="aggressive")
        assert m.sync_policy is None
        with pytest.raises(ValueError, match="nan_policy"):
            m.set_resilience_policy(nan_policy="explode")
        assert m.nan_policy is None


def test_strict_false_tolerates_missing_key_with_integrity():
    def run(S):
        sd = _persistent_sum(S, 5.0).state_dict(integrity=True)
        del sd["x"]
        fresh = S.DummySum(**S.eager)
        fresh.persistent(True)
        fresh.load_state_dict(sd, strict=False)  # no error
        bad = S.fi.corrupt_state_dict(_persistent_sum(S, 5.0).state_dict(integrity=True), mode="bitflip")
        with pytest.raises(S.res.StateCorruptionError):
            fresh.load_state_dict(bad, strict=False)
        return float(host(fresh.x))

    assert both(run) == (0.0, 0.0)


def test_quarantine_forward_on_cat_state_returns_none():
    def run(S):
        q = S.DummyList(nan_policy="quarantine", **S.eager)
        with quiet():
            q(S.arr(np.float32([1.0, 2.0])))
            out = q(S.arr(np.float32([3.0, np.nan])))
            q(S.arr(np.float32([5.0])))
        assert out is None
        return host(q.compute()).tolist(), q.resilience_report().quarantined_updates

    assert both(run) == (([1.0, 2.0, 5.0], 1), ([1.0, 2.0, 5.0], 1))


def _full_state_cls(S):
    xp = jnp if S is JAX else torch

    class FullState(S.Metric):
        full_state_update = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", xp.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + xp.sum(xp.asarray(x))

        def compute(self):
            return self.total

    return FullState


def test_quarantine_full_state_forward_records_one_event():
    def run(S):
        q = _full_state_cls(S)(nan_policy="quarantine", **S.eager)
        with quiet():
            q(S.arr(np.float32([1.0, 2.0])))
            out = q(S.arr(np.float32([1.0, np.nan])))
        report = q.resilience_report()
        return out is None, report.quarantined_updates, len(report.events), float(host(q.compute()))

    assert both(run) == ((True, 1, 1, 3.0), (True, 1, 1, 3.0))


def test_nan_policy_on_stateless_wrapper_warns_noop():
    for S in (JAX, PORT):
        m = S.tm.wrappers.BootStrapper(
            S.tm.classification.BinaryAccuracy(validate_args=False, **S.kw), num_bootstraps=2, seed=0,
            nan_policy="quarantine", **S.kw,
        )
        with pytest.warns(UserWarning, match="guards nothing"):
            m.update(S.arr([1, 0, 1]), S.arr([1, 1, 0]))


def test_collection_load_is_atomic_on_corruption():
    def run(S):
        mc = _collection(S, ("a_acc", "b_mse"))
        mc.persistent(True)
        mc.update(S.arr([0, 1, 2]), S.arr([0, 1, 1]))
        bad = S.fi.corrupt_state_dict(mc.state_dict(integrity=True), key="b_mse.sum_squared_error", mode="bitflip")
        fresh = _collection(S, ("a_acc", "b_mse"))
        fresh.persistent(True)
        before = host(fresh["a_acc"].tp).copy()
        with pytest.raises(S.res.StateCorruptionError) as err:
            fresh.load_state_dict(bad)
        np.testing.assert_array_equal(host(fresh["a_acc"].tp), before)  # the clean member was not touched
        return err.value.corrupted

    j, p = both(run)
    assert j == p == {"b_mse.sum_squared_error": "checksum mismatch (bytes differ from what was saved)"}


def test_collection_repair_atomic_on_bad_schema_version():
    def run(S):
        mc = _collection(S, ("a_acc", "b_mse"))
        mc.persistent(True)
        mc.update(S.arr([0, 1, 2]), S.arr([0, 1, 1]))
        sd = mc.state_dict(integrity=True)
        key = S.integrity.integrity_key("b_mse.")
        sd[key] = dict(sd[key], version=S.res.INTEGRITY_VERSION + 5)
        fresh = _collection(S, ("a_acc", "b_mse"))
        fresh.persistent(True)
        with pytest.raises(S.res.StateCorruptionError, match="schema version"):
            fresh.load_state_dict(sd, strict="repair")
        return host(fresh["a_acc"].tp).tolist()

    assert both(run) == ([0, 0, 0], [0, 0, 0])  # nothing loaded


def test_corrupt_state_dict_does_not_alias_integrity_block():
    for S in (JAX, PORT):
        sd = _persistent_sum(S, 5.0).state_dict(integrity=True)
        bad = S.fi.corrupt_state_dict(sd, mode="bitflip")
        bad[S.integrity.integrity_key()]["version"] = 99
        assert sd[S.integrity.integrity_key()]["version"] == S.res.INTEGRITY_VERSION


def test_full_state_forward_reports_correct_stream_position():
    def run(S):
        q = _full_state_cls(S)(nan_policy="quarantine", **S.eager)
        with quiet():
            q(S.arr(np.float32([1.0])))
            q(S.arr(np.float32([2.0])))
            q(S.arr(np.float32([np.nan])))
        return q.resilience_report().events[0].detail

    j, p = both(run)
    assert j == p and "guarded batch 3" in p


def test_quarantine_event_reports_stream_position():
    def run(S):
        q = _mse(S, nan_policy="quarantine")
        p, t = S.arr(np.ones(8, np.float32)), S.arr(np.zeros(8, np.float32))
        with quiet():
            for _ in range(4):
                q(p, t)
            q(S.fi.poison_nans(p), t)
        return q.resilience_report().events[0].detail

    j, p = both(run)
    assert j == p and "guarded batch 5" in p


def test_nan_policy_pins_eager_path():
    def run(S):
        m = S.tm.MeanSquaredError(nan_policy="raise", **S.kw)  # auto_compile on: the policy keeps it eager
        p, t = S.arr(np.ones(8, np.float32)), S.arr(np.zeros(8, np.float32))
        for _ in range(4):
            m.update(p, t)
        return "_auto_update_fn" in m.__dict__

    assert both(run) == (False, False)


# ------------------------------------------------------- added for the port
def _guarded(S, cls):
    """``cls`` plus a float state summing the predictions: the sentinel's NaN, whatever the counts are.

    Argmax of a NaN row is a finite label, so a poisoned batch leaves the
    stat scores and the confusion matrix finite; the extra state makes the
    batch one to drop, after the metric's own update wrote into its counts.
    """
    xp = jnp if S is JAX else torch

    class Guarded(cls):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("preds_sum", xp.zeros(()), dist_reduce_fx="sum")

        def update(self, preds, target):
            super().update(preds, target)
            if S is JAX:
                self.preds_sum = self.preds_sum + jnp.sum(preds)
            else:
                self.preds_sum += preds.sum()

    return Guarded


_IN_PLACE = {
    # (class, kwargs, batch drawer): MSE adds into `sum_squared_error`, stat scores into `tp`..., the confusion
    # matrix (B1's route from 256 classes; its plain version on the CPU) into `confmat` through `out=`
    "MeanSquaredError": ("MeanSquaredError", {},
                         lambda rng: (rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32))),
    "MulticlassStatScores": ("classification.MulticlassStatScores", {"num_classes": 5, "average": None},
                             lambda rng: (rng.normal(size=(16, 5)).astype(np.float32), rng.integers(0, 5, 16))),
    "MulticlassConfusionMatrix": ("classification.MulticlassConfusionMatrix", {"num_classes": 300},
                                  lambda rng: (rng.normal(size=(64, 300)).astype(np.float32), rng.integers(0, 300, 64))),
}


def _resolve(S, dotted):
    obj = S.tm
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("name", list(_IN_PLACE))
def test_quarantine_rolls_back_in_place_updates(name):
    """A quarantined batch leaves every state equal to its value before the batch.

    The port's updates write into their state tensors; a rollback point that
    kept references, as the JAX package's may (its arrays are immutable),
    would restore the very tensors the poisoned batch wrote into.
    """
    path, kwargs, draw = _IN_PLACE[name]
    rng = np.random.default_rng(7)
    batches = [draw(rng) for _ in range(3)]
    poisoned = (np.array(batches[1][0], copy=True), batches[1][1])
    poisoned[0].reshape(-1)[: poisoned[0].size // 2] = np.nan

    def run(S):
        cls = _resolve(S, path)
        m = (cls if name == "MeanSquaredError" else _guarded(S, cls))(nan_policy="quarantine", **kwargs, **S.eager)
        m.update(*[S.arr(a) for a in batches[0]])
        before = {k: host(v).copy() for k, v in m.state_dict(all_states=True).items()}
        with quiet():
            m.update(*[S.arr(a) for a in poisoned])
        after = {k: host(v) for k, v in m.state_dict(all_states=True).items()}
        m.update(*[S.arr(a) for a in batches[2]])
        return before, after, host(m.compute()), m.resilience_report().quarantined_updates, m._update_count

    (jb, ja, jv, jq, jn), (pb, pa, pv, pq, pn) = both(run)
    assert jq == pq == 1 and jn == pn == 2
    assert set(pb) == set(jb)
    for key in pb:
        np.testing.assert_array_equal(pa[key], pb[key])
        np.testing.assert_array_equal(ja[key], jb[key])
    close(jv, pv)


_DIGEST_CASES = {
    "float32_sum": lambda S: _digest_metric(S, "MeanAbsoluteError", {}, 0),
    "int_list_state": lambda S: _digest_metric(S, "classification.BinaryAUROC", {"thresholds": None}, 1),
    "float_list_state": lambda S: _digest_metric(S, "CatMetric", {}, 2),
    "mean_metric": lambda S: _digest_metric(S, "MeanMetric", {}, 3),
}


def _digest_metric(S, path, kwargs, kind):
    rng = np.random.default_rng(40 + kind)
    m = _resolve(S, path)(**kwargs, **S.eager)
    for _ in range(2):
        if kind in (0,):
            m.update(S.arr(rng.normal(size=8).astype(np.float32)), S.arr(rng.normal(size=8).astype(np.float32)))
        elif kind == 1:
            m.update(S.arr(rng.random(8).astype(np.float32)), S.arr(rng.integers(0, 2, 8)))
        else:
            m.update(S.arr(rng.normal(size=8).astype(np.float32)))
    return m.state_dict(integrity=True, all_states=True)


@pytest.mark.parametrize("case", list(_DIGEST_CASES))
def test_integrity_digests_equal_the_jax_packages(case):
    """Per-state sha256 over dtype name, shape and bytes: equal for states of equal dtype."""
    jsd, psd = both(_DIGEST_CASES[case])
    jstates = jsd[j_integrity.integrity_key()]["states"]
    pstates = psd[t_integrity.integrity_key()]["states"]
    assert set(jstates) == set(pstates)
    compared = 0
    for key, entry in pstates.items():
        jdt = {str(np.asarray(a).dtype) for a in (jsd[key] if isinstance(jsd[key], list) else [jsd[key]])}
        pdt = {str(host(a).dtype) for a in (psd[key] if isinstance(psd[key], list) else [psd[key]])}
        if jdt == pdt:
            assert entry == jstates[key], key
            compared += 1
        else:  # int64 here where the JAX package keeps int32 (ROADMAP §C): only finiteness agrees
            assert entry["finite"] == jstates[key]["finite"]
    assert compared


def test_bfloat16_digest_hashes_raw_words():
    """A bf16 state hashes as ``bfloat16`` plus its 2-byte words, as an ``ml_dtypes`` array does in the JAX package."""
    values = np.float32([1.5, -2.25, 3.0e10, 0.0])
    t = torch.tensor(values).to(torch.bfloat16)
    j = jnp.asarray(values).astype(jnp.bfloat16)
    assert t_integrity._checksum(t) == j_integrity._checksum(np.asarray(j))
    assert t_integrity._checksum(t_integrity.to_host(t)) == t_integrity._checksum(t)
    assert torch.equal(t_integrity.from_host(np.asarray(j)), t)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_integrity_checkpoints_cross_packages(direction):
    """A checkpoint with its integrity block loads into the other package, verified before the integer casts."""
    rng = np.random.default_rng(3)
    data = [(rng.normal(size=(12, 3)).astype(np.float32), rng.integers(0, 3, 12)) for _ in range(2)]

    def build(S):
        return S.tm.MetricCollection({"acc": _acc(S), "mse": _mse(S)})

    src_side, dst_side = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    src = build(src_side)
    src.persistent(True)
    for p, t in data:
        src.update(src_side.arr(p.argmax(1)), src_side.arr(t))
    sd = src.state_dict(integrity=True)
    moved = {k: (v if k.endswith("#integrity") else
                 (torch.as_tensor(np.array(host(v))) if dst_side is PORT else np.asarray(host(v))))
             for k, v in sd.items()}
    dst = build(dst_side)
    dst.persistent(True)
    dst.load_state_dict(moved)
    for name in ("acc", "mse"):
        for key in dst[name]._defaults:
            np.testing.assert_array_equal(host(getattr(dst[name], key)).astype(np.float64),
                                          host(getattr(src[name], key)).astype(np.float64))
    want = {"acc": _acc(dst_side)._defaults["tp"], "mse": _mse(dst_side)._defaults["total"]}
    assert host(dst["acc"].tp).dtype == host(want["acc"]).dtype  # cast to the receiving package's counts
    assert host(dst["mse"].total).dtype == host(want["mse"]).dtype
    bad = src_side.fi.corrupt_state_dict(sd, key="acc.tp", mode="bitflip")
    bad = {k: (v if k.endswith("#integrity") else
               (torch.as_tensor(np.array(host(v))) if dst_side is PORT else np.asarray(host(v)))) for k, v in bad.items()}
    with pytest.raises(dst_side.res.StateCorruptionError):
        build(dst_side).load_state_dict(bad)


def test_state_from_jax_carries_the_integrity_block():
    """``state_from_jax`` keeps a JAX checkpoint's block, and the port verifies it on load."""
    from torchmetrics_tpu_torch.utilities import state_from_jax

    jm = _mse(JAX)
    jm.update(jnp.ones(4), jnp.zeros(4))
    sd = jm.state_dict(integrity=True, all_states=True)
    pm = _mse(PORT)
    pm.load_state_dict(state_from_jax(sd, device="cpu"))
    assert float(pm.compute()) == float(jm.compute()) and pm.total.dtype == torch.int64
    bad = state_from_jax(j_fi.corrupt_state_dict(sd, key="sum_squared_error"), device="cpu")
    with pytest.raises(t_res.StateCorruptionError):
        _mse(PORT).load_state_dict(bad)


def test_merge_state_verifies_an_integrity_block():
    """``merge_state`` of an intact block equals a plain merge; a corrupted one raises and merges nothing."""

    def run(S):
        rng = np.random.default_rng(5)
        a, b = _mse(S), _mse(S)
        for m in (a, b):
            m.update(S.arr(rng.normal(size=8).astype(np.float32)), S.arr(rng.normal(size=8).astype(np.float32)))
        plain = _mse(S)
        plain.merge_state(a.state_dict(all_states=True))
        checked = _mse(S)
        checked.merge_state(a.state_dict(all_states=True, integrity=True))
        bad = S.fi.corrupt_state_dict(b.state_dict(all_states=True, integrity=True), mode="bitflip")
        with pytest.raises(S.res.StateCorruptionError):
            checked.merge_state(bad)
        return host(plain.compute()), host(checked.compute()), checked._update_count

    (jp, jc, jn), (pp, pc, pn) = both(run)
    assert jn == pn == 1
    np.testing.assert_array_equal(pp, pc)
    close(jc, pc)


# ------------------------------------------------------------------ satellites
RNG = np.random.default_rng(11)


def _poisoned_stat_scores(S, rng):
    m = S.tm.classification.BinaryStatScores(**S.kw)  # validate_args: the compiled step carries the checks
    good_p, good_t = rng.random(8).astype(np.float32), rng.integers(0, 2, 8)
    for _ in range(3):
        m.update(S.arr(good_p), S.arr(good_t))
    assert "_auto_update_fn" in m.__dict__
    m.update(S.arr(good_p), S.arr(np.full(8, 7)))  # compiled: a deferred violation
    return m


def test_single_reset_raises_and_resets():
    def run(S):
        rng = np.random.default_rng(11)
        m = _poisoned_stat_scores(S, rng)
        with pytest.raises(RuntimeError, match="outside of the expected set"):
            m.reset()
        out = (m._update_count, host(m.tp).tolist())
        m.update(S.arr(rng.random(8).astype(np.float32)), S.arr(rng.integers(0, 2, 8)))
        return out + (m._update_count,)

    j, p = both(run)
    assert j[0] == p[0] == 0 and j[2] == p[2] == 1
    assert np.all(np.asarray(p[1]) == 0) and np.all(np.asarray(j[1]) == 0)


def test_forward_with_pending_violation_preserves_accumulation():
    def run(S):
        rng = np.random.default_rng(11)
        m = _poisoned_stat_scores(S, rng)
        count, tp = m._update_count, host(m.tp).copy()
        with pytest.raises(RuntimeError, match="outside of the expected set"):
            m(S.arr(rng.random(8).astype(np.float32)), S.arr(rng.integers(0, 2, 8)))
        assert m._update_count == count
        np.testing.assert_array_equal(host(m.tp), tp)
        return count, tp.tolist()

    j, p = both(run)
    assert j == p


def test_clean_reset_unchanged():
    for S in (JAX, PORT):
        m = S.tm.classification.BinaryStatScores(**S.kw)
        m.update(S.arr(RNG.random(8).astype(np.float32)), S.arr(RNG.integers(0, 2, 8)))
        m.reset()
        assert m._update_count == 0


def test_collection_reset_resets_all_members_despite_violation():
    for S in (JAX, PORT):
        rng = np.random.default_rng(11)
        a = _poisoned_stat_scores(S, rng)
        b = S.tm.classification.BinaryStatScores(**S.kw)
        b.update(S.arr(rng.random(8).astype(np.float32)), S.arr(rng.integers(0, 2, 8)))
        mc = S.tm.MetricCollection({"a": a, "b": b}, compute_groups=False)
        with pytest.raises(RuntimeError, match="outside of the expected set"):
            mc.reset()
        assert a._update_count == 0 and b._update_count == 0


def test_deferred_message_matches_reference_pattern():
    def run(S):
        rng = np.random.default_rng(11)
        m = _poisoned_stat_scores(S, rng)
        with pytest.raises(RuntimeError) as err:
            m.compute()
        return str(err.value)

    for msg in both(run):
        assert "Detected the following values in `target`" in msg and "expected only" in msg
        assert "outside of the expected set" in msg and "omitted" in msg


def test_eager_message_still_matches_same_pattern():
    for S in (JAX, PORT):
        m = S.tm.classification.BinaryStatScores(**S.kw)
        with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
            m.update(S.arr(RNG.random(8).astype(np.float32)), S.arr(np.full(8, 7)))


def _mutating_cls(S, container_factory, mutate):
    xp = jnp if S is JAX else torch

    class Mutating(S.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", xp.zeros(()), dist_reduce_fx="sum")
            self.bag = container_factory()

        def update(self, x):
            self.total = self.total + xp.sum(x)
            mutate(self.bag)

        def compute(self):
            return self.total

    return Mutating


def _bump_list(bag):
    bag[0] += 1


def _bump_dict(bag):
    bag["k0"] += 1


@pytest.mark.parametrize(
    ("factory", "mutate", "disabled"),
    [
        (lambda: list(range(32)), _bump_list, True),
        (lambda: {f"k{i}": 0 for i in range(32)}, _bump_dict, True),
        (lambda: list(range(32)), lambda bag: None, False),
    ],
    ids=["large_list_inplace_mutation_detected", "large_dict_inplace_mutation_detected",
         "untouched_large_container_keeps_compiled_path"],
)
def test_large_container_fingerprint(factory, mutate, disabled):
    def run(S):
        m = _mutating_cls(S, factory, mutate)(**S.kw)
        for _ in range(3):
            m.update(S.arr(np.ones(4, np.float32)))
        return m._auto_disabled, "_auto_update_fn" in m.__dict__

    assert both(run) == ((disabled, not disabled), (disabled, not disabled))


def _boot(S):
    return S.tm.wrappers.BootStrapper(S.tm.classification.BinaryAccuracy(validate_args=False, **S.kw),
                                      num_bootstraps=4, seed=0, **S.kw)


def _binary_batches(rng, size, n):
    return [(rng.integers(0, 2, size), rng.integers(0, 2, size)) for _ in range(n)]


def test_size1_stream_stays_on_loop_path():
    def run(S):
        m = _boot(S)
        for p, t in _binary_batches(np.random.default_rng(11), 1, 4):
            m.update(S.arr(p), S.arr(t))
        return m._stacked is None, m._fast_disabled, set(m._fast_checked_sizes)

    assert both(run) == ((True, False, set()), (True, False, set()))


def test_size1_licensed_after_passed_check():
    def run(S):
        rng = np.random.default_rng(11)
        m = _boot(S)
        for p, t in _binary_batches(rng, 8, 2):
            m.update(S.arr(p), S.arr(t))
        sizes = set(m._fast_checked_sizes)
        (p, t), = _binary_batches(rng, 1, 1)
        m.update(S.arr(p), S.arr(t))
        return sizes, m._stacked is not None

    assert both(run) == (({8}, True), ({8}, True))


def test_size1_then_size8_recovers_fast_path():
    def run(S):
        rng = np.random.default_rng(11)
        m = _boot(S)
        for p, t in _binary_batches(rng, 1, 3) + _binary_batches(rng, 8, 1):
            m.update(S.arr(p), S.arr(t))
        sizes = set(m._fast_checked_sizes)
        (p, t), = _binary_batches(rng, 1, 1)
        m.update(S.arr(p), S.arr(t))
        return sizes, m._stacked is not None, float(host(m.compute()["mean"]))

    (js, jst, jv), (ps, pst, pv) = both(run)
    assert js == ps == {8} and jst and pst
    assert np.isfinite(pv) and np.isfinite(jv)
