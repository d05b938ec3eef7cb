"""The SPMD engine's specs and its sync, against the JAX package.

From ``tests/unittests/spmd/test_specs.py``: the collective of each
``dist_reduce_fx`` kind, the stacked layout's spec, the refused states, the
mesh and the eligibility gate. Not ported: the JAX test of the switch that
turns the static analysis off (the port has no ``_analysis/``, so its gate
reads the eligibility copy alone) and the one that reads each unsupported
verdict's reasons (the port's copy keeps the verdicts only). Added for the
port: a mesh over two cards, or on another device than the metric's, is
refused at construction.

The port's ``sync_in_jit`` is held against the JAX ``sync_in_jit`` run under
``shard_map`` on the 8 CPU devices (``tests/conftest.py``), for the same
per-device numpy inputs: every reduction kind of
``tests/unittests/bases/test_ddp.py`` and the ring buffers of
``test_ringbuffer.py:296-333``, ungrouped and in groups, and the refused
groups and reductions with the JAX messages. Counts and masks must be equal;
floats within ``RTOL`` (a sum over 8 rows may add in another order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec

import torchmetrics_tpu_torch as TM
from torchmetrics_tpu.utilities.distributed import shard_map
from torchmetrics_tpu.utilities.distributed import sync_in_jit as jax_sync_in_jit
from torchmetrics_tpu.utilities.ringbuffer import RingBuffer as JaxRing
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch._spmd import (
    COLLECTIVE_FOR,
    InGraphSyncUnsupported,
    build_mesh,
    state_specs,
    sync_plan,
    validate_reductions,
)
from torchmetrics_tpu_torch._spmd.specs import in_graph_sync_eligible
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities import sync_in_jit

WORLD = 8
RTOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]
FACETS = json.loads((ROOT / "torchmetrics_tpu_torch" / "_eligibility.json").read_text())["in_graph_sync"]


class _AllKinds(Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(cat_state_capacity=64, device="cpu", **kw)
        self.add_state("s_sum", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("s_mean", default=torch.zeros(()), dist_reduce_fx="mean")
        self.add_state("s_max", default=torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("s_min", default=torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("s_cat", default=[], dist_reduce_fx="cat")

    def update(self, x):
        self.s_sum = self.s_sum + x.sum()
        self.s_mean = x.mean()
        self.s_max = torch.maximum(self.s_max, x.max())
        self.s_min = torch.minimum(self.s_min, x.min())
        self.s_cat.append(x)

    def compute(self):
        return self.s_sum


def test_collective_per_reduction_kind():
    """Every dist_reduce_fx kind maps onto its declared in-graph collective."""
    assert validate_reductions(_AllKinds()) == {
        "s_sum": "psum", "s_mean": "pmean", "s_max": "pmax", "s_min": "pmin", "s_cat": "all_gather",
    }
    assert set(COLLECTIVE_FOR) == {"sum", "mean", "max", "min", "cat", None}


def test_state_specs_shard_leading_device_axis():
    assert state_specs(["a", "b"], "dp") == {"a": ("dp",), "b": ("dp",)}


def test_unbounded_cat_state_rejected():
    class _Unbounded(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("vals", default=[], dist_reduce_fx="cat")

        def update(self, x):
            self.vals.append(x)

        def compute(self):
            return torch.zeros(())

    with pytest.raises(InGraphSyncUnsupported, match="cat_state_capacity"):
        validate_reductions(_Unbounded())


def test_callable_reductions_rejected_none_gathers():
    assert sync_plan({"a": None}) == {"a": "all_gather"}
    with pytest.raises(InGraphSyncUnsupported, match="callable"):
        sync_plan({"a": lambda x: x})


def test_list_typed_gather_state_rejected():
    class _ListNone(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("vals", default=[], dist_reduce_fx=None)

        def update(self, x):
            self.vals.append(x)

        def compute(self):
            return torch.zeros(())

    with pytest.raises(InGraphSyncUnsupported, match="fixed per-device shape"):
        validate_reductions(_ListNone())


def test_build_mesh_default_axis():
    mesh = build_mesh("dp", ["cpu"] * WORLD)
    assert mesh.axis_names == ("dp",) and mesh.shape["dp"] == WORLD
    if torch.cuda.device_count():
        assert build_mesh().shape["dp"] == torch.cuda.device_count()
    else:  # the default is every visible card: none here
        with pytest.raises(InGraphSyncUnsupported, match="no devices"):
            build_mesh()


def test_mesh_over_two_cards_or_off_the_metrics_device_refused():
    with pytest.raises(InGraphSyncUnsupported, match="one process a card"):
        TM.MeanSquaredError(device="cpu").to_spmd(mesh=build_mesh(devices=["cuda:0", "cuda:1"]))
    with pytest.raises(InGraphSyncUnsupported, match="lives on cpu"):
        TM.MeanSquaredError(device="cpu").to_spmd(mesh=build_mesh(devices=["cuda:0"] * 2))


class TestFacetGate:
    def test_certified_safe_class(self):
        assert in_graph_sync_eligible(TM.MulticlassAccuracy) in ("safe", "runtime")

    def test_host_bound_class_keeps_eager_gather(self):
        assert in_graph_sync_eligible(TM.WordErrorRate) == "host_bound"
        with pytest.raises(InGraphSyncUnsupported, match="eager gather"):
            TM.WordErrorRate(device="cpu").to_spmd(mesh=build_mesh(devices=["cpu"]))

    def test_unknown_user_subclass_requires_opt_in(self):
        assert in_graph_sync_eligible(_AllKinds) == "unknown"
        with pytest.raises(InGraphSyncUnsupported, match="absent from the eligibility manifest"):
            _AllKinds().to_spmd(mesh=build_mesh(devices=["cpu"]))

    def test_manifest_facet_consistent_with_verdicts(self):
        """Host-bound update verdicts never certify in-graph; the others never land on the host-bound facet."""
        for qual, facet in FACETS.items():
            module, _, name = qual.rpartition(".")
            cls = getattr(__import__(module, fromlist=[name]), name)
            if _compile.eligibility_verdict(cls) == "host_bound":
                assert facet == "host_bound", qual
            else:
                assert facet in ("safe", "runtime", "unsupported"), (qual, facet)


def test_matthews_family_certified_branchless():
    assert in_graph_sync_eligible(TM.BinaryMatthewsCorrCoef) == "safe"
    unsupported = [q for q, f in FACETS.items() if f == "unsupported"]
    assert len(unsupported) <= 2, unsupported


# ------------------------------------------------------------- sync_in_jit
def _jax_sync_rows(states, reductions, groups=None):
    """The JAX sync under shard_map on the 8 CPU devices: each device's result, stacked (numpy)."""

    def body(local):
        loc = {
            n: JaxRing(int(v["data"].shape[1]), _data=v["data"][0], _valid=v["valid"][0], _count=v["count"][0])
            if isinstance(v, dict) else v[0]
            for n, v in local.items()
        }
        out = jax_sync_in_jit(loc, reductions, "dp", axis_index_groups=groups)
        return {
            n: {"data": v.data[None], "valid": v.valid[None], "count": v.count[None]} if isinstance(v, JaxRing) else v[None]
            for n, v in out.items()
        }

    mesh = JaxMesh(np.array(jax.devices()), ("dp",))
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(PartitionSpec("dp"),), out_specs=PartitionSpec("dp"),
                           check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(jax.tree_util.tree_map(jnp.asarray, states)))


def _port_sync_rows(states, reductions, groups=None):
    out = sync_in_jit(
        {n: {k: torch.from_numpy(x) for k, x in v.items()} if isinstance(v, dict) else torch.from_numpy(v)
         for n, v in states.items()},
        reductions, "dp", axis_index_groups=groups,
    )
    return {n: {k: x.numpy() for k, x in v.items()} if isinstance(v, dict) else v.numpy() for n, v in out.items()}


def _agree(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7, err_msg=what)
    else:  # counts and masks: equal
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


RNG = np.random.default_rng(20)
GROUPINGS = {"all": None, "halves": [[0, 1, 2, 3], [4, 5, 6, 7]], "strided": [[0, 2, 4, 6], [1, 3, 5, 7]],
             "pairs": [[6, 7], [0, 1], [2, 3], [4, 5]]}
KINDS = {
    "sum_f32": ("sum", RNG.standard_normal((WORLD, 3)).astype(np.float32)),
    "sum_i32": ("sum", RNG.integers(0, 1000, (WORLD, 5, 5)).astype(np.int32)),
    "mean_f32": ("mean", RNG.standard_normal((WORLD, 3)).astype(np.float32)),
    "mean_i32": ("mean", RNG.integers(0, 1000, (WORLD, 3)).astype(np.int32)),
    "max_f32": ("max", RNG.standard_normal((WORLD,)).astype(np.float32)),
    "max_i32": ("max", RNG.integers(-50, 50, (WORLD, 4)).astype(np.int32)),
    "min_f32": ("min", RNG.standard_normal((WORLD, 2, 2)).astype(np.float32)),
    "cat_f32": ("cat", RNG.standard_normal((WORLD, 4, 2)).astype(np.float32)),
    "gather_none": (None, RNG.standard_normal((WORLD, 6)).astype(np.float32)),
}


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sync_in_jit_matches_jax_per_device(kind, grouping):
    red, value = KINDS[kind]
    groups = GROUPINGS[grouping]
    got = _port_sync_rows({"s": value}, {"s": red}, groups)["s"]
    want = _jax_sync_rows({"s": value}, {"s": red}, groups)["s"]
    _agree(got, want, f"{kind}/{grouping}")
    assert got.dtype == want.dtype, (kind, got.dtype, want.dtype)


@pytest.mark.parametrize("grouping", ["all", "halves"])
def test_sync_in_jit_callable_reduction_matches_jax(grouping):
    value = RNG.standard_normal((WORLD, 3)).astype(np.float32)
    groups = GROUPINGS[grouping]
    got = _port_sync_rows({"s": value}, {"s": lambda m: (m * m).sum(0)}, groups)["s"]
    want = _jax_sync_rows({"s": value}, {"s": lambda m: jnp.sum(m * m, axis=0)}, groups)["s"]
    _agree(got, want, grouping)


def _ring_rows(cap, counts):
    """Stacked ring leaves of rows that hold ``counts[d]`` appended rows each (not yet wrapped)."""
    data = RNG.standard_normal((WORLD, cap, 2)).astype(np.float32)
    valid = np.arange(cap)[None, :] < np.minimum(np.asarray(counts), cap)[:, None]
    data[~valid] = 0.0
    return {"data": data, "valid": valid, "count": np.asarray(counts, np.int32)}


@pytest.mark.parametrize("grouping", ["all", "halves", "strided"])
def test_sync_in_jit_ring_buffers_match_jax(grouping):
    groups = GROUPINGS[grouping]
    ring = _ring_rows(4, [0, 1, 2, 3, 4, 4, 2, 1])
    got = _port_sync_rows({"vals": ring}, {"vals": "cat"}, groups)["vals"]
    want = _jax_sync_rows({"vals": ring}, {"vals": "cat"}, groups)["vals"]
    for part in ("data", "valid", "count"):
        _agree(got[part], want[part], f"{grouping} ring {part}")
    # every row sees the live rows of its whole group (the JAX ring test's sum)
    members = groups or [list(range(WORLD))]
    for g in members:
        total = float(sum(ring["data"][d][ring["valid"][d]].sum() for d in g))
        for d in g:
            assert np.isclose(got["data"][d][got["valid"][d]].sum(), total, rtol=1e-6)
            assert int(got["count"][d]) == int(ring["count"][list(g)].sum())


def test_sync_in_jit_without_groups_is_an_expand():
    value = torch.arange(WORLD * 3, dtype=torch.float32).reshape(WORLD, 3)
    out = sync_in_jit({"s": value}, {"s": "sum"})["s"]
    assert out.shape == (WORLD, 3) and out.stride()[0] == 0


@pytest.mark.parametrize("groups", [[[0, 1], [2, 3, 4, 5, 6, 7]], [[0, 1, 2, 3], [3, 4, 5, 6]]])
def test_bad_groups_raise_the_jax_message(groups):
    value = RNG.standard_normal((WORLD, 3)).astype(np.float32)
    with pytest.raises(ValueError) as port_err:
        _port_sync_rows({"s": value}, {"s": "sum"}, groups)
    with pytest.raises(ValueError) as jax_err:
        _jax_sync_rows({"s": value}, {"s": "sum"}, groups)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize(("state", "red"), [("plain", "median"), ("ring", "sum")])
def test_bad_reductions_raise_the_jax_message(state, red):
    value = _ring_rows(2, [1] * WORLD) if state == "ring" else RNG.standard_normal((WORLD, 3)).astype(np.float32)
    with pytest.raises(ValueError) as port_err:
        _port_sync_rows({"s": value}, {"s": red})
    with pytest.raises(ValueError) as jax_err:
        _jax_sync_rows({"s": value}, {"s": red})
    assert str(port_err.value) == str(jax_err.value)


def test_metric_sync_in_jit_rows_equal_one_device():
    """``Metric.sync_in_jit``: the confusion matrices of 8 rows' shards sum to one metric's on the whole batch."""
    c = 5
    preds, target = RNG.integers(0, c, (WORLD, 16)), RNG.integers(0, c, (WORLD, 16))
    rows = []
    for d in range(WORLD):
        m = TM.MulticlassConfusionMatrix(num_classes=c, device="cpu")
        m.update(torch.from_numpy(preds[d]), torch.from_numpy(target[d]))
        rows.append(m.confmat)
    whole = TM.MulticlassConfusionMatrix(num_classes=c, device="cpu")
    whole.update(torch.from_numpy(preds.reshape(-1)), torch.from_numpy(target.reshape(-1)))
    synced = whole.sync_in_jit({"confmat": torch.stack(rows)}, "dp")["confmat"]
    assert all(torch.equal(synced[d], whole.confmat) for d in range(WORLD))
    grouped = TM.MulticlassConfusionMatrix(num_classes=c, device="cpu", process_group=object())
    with pytest.raises(Exception, match="axis_index_groups"):
        grouped.sync_in_jit({"confmat": torch.stack(rows)}, "dp")
