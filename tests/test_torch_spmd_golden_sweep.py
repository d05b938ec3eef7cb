"""The SPMD engine against the eager stream across the certified class sweep.

From ``tests/unittests/spmd/test_golden_sweep.py``: every class of the
compiled-default sweep (``tests/unittests/analysis/test_compiled_default_path.py``
``CASES``) that both packages certify for the in-graph path
(``in_graph_sync`` facet ``safe``/``runtime``) is driven through the port's
engine on 8 CPU rows for three steps of the JAX sweep's batch, and must
match the port's eager stream at the JAX sweep's ``rtol=1e-4, atol=1e-6``
on every computed leaf (counts equal), without degrading. The port's facets
must be the JAX package's, class for class. The JAX engine on its 8 CPU
devices is compared on a subset only, to keep the file cheap: a class of
each reduction kind the sweep holds (sum, max, min), Pearson's gathered
moments, and a ring state (``CatMetric`` with ``cat_state_capacity``: the
same rows must come out of both engines).
"""

import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as TM
from tests.unittests.analysis.test_compiled_default_path import CASES
from torchmetrics_tpu._analysis.manifest import in_graph_sync_eligible as jax_in_graph_sync_eligible
from torchmetrics_tpu_torch import aggregation as TA
from torchmetrics_tpu_torch._spmd import build_mesh
from torchmetrics_tpu_torch._spmd.specs import in_graph_sync_eligible

WORLD = 8
RTOL, ATOL = 1e-4, 1e-6
MESH = build_mesh(devices=["cpu"] * WORLD)
ROOT = Path(__file__).resolve().parents[1]


def _jax_sweep():
    return [name for name, (ctor, _) in sorted(CASES.items()) if jax_in_graph_sync_eligible(type(ctor())) in ("safe", "runtime")]


SWEEP = _jax_sweep()
JAX_SUBSET = ["MaxMetric", "MinMetric", "MulticlassConfusionMatrix", "PearsonCorrCoef"]


def _port_kwargs(name):
    """The JAX case's class-count arguments, as the port's class of it takes them."""
    if name == "MinkowskiDistance":
        return {"p": 3.0}
    jm = CASES[name][0]()
    return {k: getattr(jm, k) for k in ("num_classes", "num_labels", "num_groups") if getattr(jm, k, None) is not None}


def _port_ctor(name):
    """The port's class of the JAX case, with the JAX instance's class-count arguments."""
    cls = getattr(TM, name, None) or getattr(TA, name)
    kwargs = _port_kwargs(name)
    return lambda **kw: cls(device="cpu", **kwargs, **kw)


def _leaves(value):
    """A computed value's arrays in a fixed order (dict keys sorted), as numpy, with whether each is floating."""
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _leaves(value[k])]
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _leaves(v)]
    arr = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
    return [(arr, np.issubdtype(arr.dtype, np.floating))]


def _agree(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for (a, a_float), (b, _) in zip(g, w):
        if a_float:
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=RTOL, atol=ATOL, err_msg=what)
        else:  # counts: equal
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


def test_sweep_covers_a_real_population():
    assert len(SWEEP) == 41, SWEEP
    # the port's gate certifies exactly the classes the JAX gate does
    assert [n for n in SWEEP if in_graph_sync_eligible(type(_port_ctor(n)())) in ("safe", "runtime")] == SWEEP


def test_port_facets_are_the_jax_facets():
    port = json.loads((ROOT / "torchmetrics_tpu_torch" / "_eligibility.json").read_text())["in_graph_sync"]
    jax_classes = json.loads((ROOT / "torchmetrics_tpu" / "_analysis" / "eligibility.json").read_text())["classes"]
    jax_facets = {q.replace("torchmetrics_tpu.", "torchmetrics_tpu_torch.", 1): e["in_graph_sync"]["verdict"]
                  for q, e in jax_classes.items()}
    assert port == {q: f for q, f in jax_facets.items() if q in port}
    assert len(port) == 204


@pytest.mark.parametrize("name", SWEEP)
def test_in_graph_matches_eager(name):
    ctor = _port_ctor(name)
    args = tuple(torch.from_numpy(np.array(a)) for a in CASES[name][1]())
    assert args[0].shape[0] % WORLD == 0, "sweep batch must shard evenly"
    eng = ctor().to_spmd(mesh=MESH)
    eager = ctor(auto_compile=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            fused = eng.step(*args)
            eager.update(*args)
        want = eager.compute()
    assert not eng.degraded, f"{name} degraded off the in-graph path"
    _agree(fused, want, name)


@pytest.mark.parametrize("name", JAX_SUBSET)
def test_in_graph_matches_the_jax_engine(name):
    jax_ctor, maker = CASES[name]
    np_args = [np.array(a) for a in maker()]
    eng = _port_ctor(name)().to_spmd(mesh=MESH)
    jeng = jax_ctor().to_spmd()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            fused = eng.step(*(torch.from_numpy(a) for a in np_args))
            jfused = jeng.step(*(jax.numpy.asarray(a) for a in np_args))
    assert not eng.degraded and not jeng.degraded
    _agree(fused, jax.tree_util.tree_map(np.asarray, jfused), f"{name} vs the JAX engine")


def test_ring_state_against_the_jax_engine():
    """A ring state: the same rows come out of both engines.

    The port's ``CatMetric.compute`` returns the ring's live rows, whose
    length is data-dependent: ``vmap`` refuses it and the engine degrades,
    and its eager continuation returns the rows. The JAX class returns the
    gathered ring buffer itself, which its engine computes in-graph; its live
    rows are the same.
    """
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((32, 3)).astype(np.float32) for _ in range(3)]
    eng = TM.CatMetric(device="cpu", cat_state_capacity=128, nan_strategy="disable").to_spmd(mesh=MESH)
    jeng = jtm.CatMetric(cat_state_capacity=128, nan_strategy="disable").to_spmd()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x in xs:
            fused = eng.step(torch.from_numpy(x))
            jfused = jeng.step(jax.numpy.asarray(x))
    assert eng.degraded and not jeng.degraded
    assert "does not trace" in eng.target.resilience_report().events[-1].detail
    jax_rows = np.asarray(jfused.data)[np.asarray(jfused.valid)]
    want = np.sort(np.concatenate(xs), axis=0)
    np.testing.assert_array_equal(np.sort(fused.numpy(), axis=0), want)
    np.testing.assert_array_equal(np.sort(jax_rows, axis=0), want)
