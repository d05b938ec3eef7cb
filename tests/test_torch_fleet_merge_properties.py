"""The port's merge operator as the fleet folds it (``tests/unittests/fleet/test_merge_properties.py``).

The fleet tier's correctness reduces to one algebraic claim: ``merge_state``
is an associative, commutative fold, so a hierarchy of partial folds equals
the flat sequential fold. The property runs over the sweep that
``tests/test_torch_spmd_golden_sweep.py`` builds from the compiled-default
``CASES`` (the classes both packages certify for the in-graph path): for
each class the tree fold equals the flat fold, the flat fold equals the flat
feed, and the merge commutes, and each is held to the JAX package's value
on the same numpy batches (rtol 1e-5, atol 1e-6; counts equal). Also the
durability face of the operator (journaled merges replay after a
preemption, four regions folding on four threads; the JAX suite arms its
lock sanitizer there, the port checks that every thread ended and each
restore equals the JAX package's), a raw dict's integrity block, and
collection merges.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_spmd_golden_sweep import SWEEP, _port_ctor
from tests.unittests.analysis.test_compiled_default_path import CASES
from tests.unittests.fleet.test_merge_properties import CERTIFIED
from torchmetrics_tpu.aggregation import MeanMetric as JMean
from torchmetrics_tpu.collections import MetricCollection as JCollection
from torchmetrics_tpu.regression import MeanAbsoluteError as JMAE
from torchmetrics_tpu.regression import MeanSquaredError as JMSE
from torchmetrics_tpu._resilience import SnapshotManager as JSnapshotManager
from torchmetrics_tpu._resilience import SnapshotPolicy as JSnapshotPolicy
from torchmetrics_tpu_torch.aggregation import MeanMetric as TMean
from torchmetrics_tpu_torch.collections import MetricCollection as TCollection
from torchmetrics_tpu_torch.regression import MeanAbsoluteError as TMAE
from torchmetrics_tpu_torch.regression import MeanSquaredError as TMSE
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch._resilience import SnapshotManager, SnapshotPolicy
from torchmetrics_tpu_torch._resilience.errors import StateCorruptionError

RTOL, ATOL = 1e-5, 1e-6
SYNC = dict(async_write=False)


def _leaves(value):
    """A computed value's arrays in a fixed order (dict keys sorted), as numpy."""
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _leaves(value[k])]
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _leaves(v)]
    if isinstance(value, torch.Tensor):
        return [value.detach().cpu().numpy()]
    return [np.asarray(value)]


def _assert_same(got, want, what):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        if np.issubdtype(x.dtype, np.floating) or np.issubdtype(y.dtype, np.floating):
            np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), rtol=RTOL, atol=ATOL, err_msg=what)
        else:  # counts: equal (int64 in the port where the JAX package keeps int32)
            np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64), err_msg=what)


def _shards(name, n):
    """``n`` port shards and their JAX twins, two batches each, and a flat-fed golden of each package."""
    ctor, maker = CASES[name]
    port = _port_ctor(name)
    batches = [[np.array(a) for a in maker()] for _ in range(2 * n)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgolden = ctor()
        jgolden.auto_compile = False
        golden = port(auto_compile=False)
        shards, jshards = [], []
        for i in range(n):
            m, jm = port(auto_compile=False), ctor()
            jm.auto_compile = False
            for args in batches[2 * i:2 * i + 2]:
                m.update(*(torch.from_numpy(a) for a in args))
                golden.update(*(torch.from_numpy(a) for a in args))
                jm.update(*args)
                jgolden.update(*args)
            shards.append(m)
            jshards.append(jm)
    return shards, golden, jshards, jgolden


def _compute(m):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return m.compute()


def test_certified_set_is_wide_enough():
    # the JAX suite's floor: the property sweep covers >= 30 classes, and it is the JAX suite's own set
    assert len(SWEEP) >= 30, SWEEP
    assert sorted(SWEEP) == sorted(CERTIFIED)


@pytest.mark.parametrize("name", SWEEP)
def test_tree_fold_equals_flat_fold(name):
    """Pairwise (hierarchical) fold == sequential (flat) fold == flat feed, and == the JAX package's."""
    shards, golden, jshards, jgolden = _shards(name, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # flat: fold shards 1..3 into 0 sequentially
        flat = shards[0].clone()
        for s in shards[1:]:
            flat.merge_state(s)
        # tree: (0+1) + (2+3), the fleet's region/global shape
        left = shards[0].clone()
        left.merge_state(shards[1])
        right = shards[2].clone()
        right.merge_state(shards[3])
        left.merge_state(right)
        jleft = jshards[0].clone()
        jleft.merge_state(jshards[1])
        jright = jshards[2].clone()
        jright.merge_state(jshards[3])
        jleft.merge_state(jright)
    _assert_same(_compute(flat), _compute(golden), f"{name}: flat fold != flat feed")
    _assert_same(_compute(left), _compute(golden), f"{name}: tree fold != flat feed")
    _assert_same(_compute(left), _compute(jleft), f"{name}: tree fold != the JAX package's tree fold")
    _assert_same(_compute(golden), _compute(jgolden), f"{name}: flat feed != the JAX package's flat feed")


@pytest.mark.parametrize("name", SWEEP)
def test_merge_commutes(name):
    (a, b), _, (ja, jb), _ = _shards(name, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ab = a.clone()
        ab.merge_state(b)
        ba = b.clone()
        ba.merge_state(a)
        jab = ja.clone()
        jab.merge_state(jb)
    _assert_same(_compute(ab), _compute(ba), f"{name}: merge is not commutative")
    _assert_same(_compute(ab), _compute(jab), f"{name}: merge != the JAX package's merge")


def test_concurrent_journaled_merges_replay_after_preemption(tmp_path):
    """Regions fold shards concurrently (one metric + journal per thread); every merge is journaled and
    replayed after the preemption, in both packages, to the same values."""
    rng = np.random.default_rng(7)
    batches = [[(rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)) for _ in range(4)]
               for _ in range(4)]
    restored = {}
    for name, MSE, Manager, Policy, arr in (
        ("jax", JMSE, JSnapshotManager, JSnapshotPolicy, np.asarray),
        ("port", lambda: TMSE(device="cpu"), SnapshotManager, SnapshotPolicy, torch.as_tensor),
    ):
        regions = []
        for r, rows in enumerate(batches):
            m = MSE()
            m.update(*map(arr, rows[0]))
            shards = []
            for p, t in rows[1:]:
                s = MSE()
                s.update(arr(p), arr(t))
                shards.append(s)
            regions.append((m, shards, tmp_path / f"{name}-region-{r:02d}"))

        def _fold(m, shards, directory):
            mgr = Manager(m, directory, Policy(**SYNC))
            for s in shards:
                m.merge_state(s)
            mgr.simulate_preemption()

        threads = [threading.Thread(target=_fold, args=args) for args in regions]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
        out = []
        for m, _shards, directory in regions:
            fresh = MSE()
            with Manager(fresh, directory, Policy(**SYNC)) as mgr2:
                mgr2.restore_latest()
            assert fresh._update_count == m._update_count == 4
            np.testing.assert_allclose(np.asarray(_leaves(fresh.compute())[0]), np.asarray(_leaves(m.compute())[0]),
                                       rtol=1e-6)
            out.append(float(_leaves(fresh.compute())[0]))
        restored[name] = out
    np.testing.assert_allclose(restored["port"], restored["jax"], rtol=RTOL)


class TestRawDictMergeIntegrity:
    """``merge_state(dict)`` verifies a carried integrity block before folding: a checkpointed shard that
    rotted on disk is refused, not silently averaged in."""

    def _poisoned(self, key="value"):
        donor = TMean(device="cpu")
        donor.update(3.0)
        sd = donor.state_dict(integrity=True, all_states=True, _host=True)
        sd[key] = np.asarray(float("nan"), dtype=np.float32)
        return sd

    def test_clean_integrity_dict_merges(self):
        for Mean, host in ((JMean, False), (lambda: TMean(device="cpu"), True)):
            donor = Mean()
            donor.update(3.0)
            m = Mean()
            m.update(1.0)
            kw = {"_host": True} if host else {}
            m.merge_state(donor.state_dict(integrity=True, all_states=True, **kw))
            assert float(m.compute()) == pytest.approx(2.0)

    def test_corrupt_integrity_dict_refused_untouched(self):
        m = TMean(device="cpu")
        m.update(1.0)
        with pytest.raises(StateCorruptionError):
            m.merge_state(self._poisoned("value"))
        # target state is untouched by the refused merge
        assert float(m.compute()) == pytest.approx(1.0)

    def test_weight_corruption_also_caught(self):
        m = TMean(device="cpu")
        m.update(1.0)
        with pytest.raises(StateCorruptionError):
            m.merge_state(self._poisoned("weight"))

    def test_plain_dict_still_merges_back_compat(self):
        for Mean in (JMean, lambda: TMean(device="cpu")):
            donor = Mean()
            donor.update(5.0)
            m = Mean()
            m.update(1.0)
            m.merge_state(donor.state_dict(all_states=True))  # no integrity block
            assert float(m.compute()) == pytest.approx(3.0)


class TestCollectionMerge:
    def _pair(self, port=True):
        rng = np.random.default_rng(3)
        if port:
            def mk():
                return TCollection({"mse": TMSE(device="cpu"), "mae": TMAE(device="cpu")})
            arr = torch.as_tensor
        else:
            def mk():
                return JCollection({"mse": JMSE(), "mae": JMAE()})
            arr = np.asarray
        a, b, golden = mk(), mk(), mk()
        for col, n in ((a, 3), (b, 2)):
            for _ in range(n):
                p = rng.normal(size=8).astype(np.float32)
                t = rng.normal(size=8).astype(np.float32)
                col.update(arr(p), arr(t))
                golden.update(arr(p), arr(t))
        return a, b, golden

    def test_member_wise_merge_golden(self):
        a, b, golden = self._pair()
        a.merge_state(b)
        ja, jb, _ = self._pair(port=False)
        ja.merge_state(jb)
        got, want, jgot = a.compute(), golden.compute(), ja.compute()
        for key in want:
            _assert_same(got[key], want[key], key)
            _assert_same(got[key], jgot[key], key)

    def test_mismatched_members_refused_before_any_fold(self):
        a, _, _ = self._pair()
        other = TCollection({"mse": TMSE(device="cpu")})
        before = a.compute()["mse"].clone()
        with pytest.raises(TorchMetricsUserError):
            a.merge_state(other)
        with pytest.raises(TorchMetricsUserError):
            a.merge_state(TMSE(device="cpu"))
        # validation precedes mutation: a is exactly as it was
        assert torch.equal(a.compute()["mse"], before)

    def test_mismatched_member_types_refused(self):
        a, _, _ = self._pair()
        other = TCollection({"mse": TMAE(device="cpu"), "mae": TMAE(device="cpu")})
        with pytest.raises(TorchMetricsUserError):
            a.merge_state(other)
