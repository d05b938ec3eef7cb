"""Pool against eager across the certified class sweep, in the port and against the JAX pool.

From ``tests/unittests/streams/test_golden_sweep.py``: every class of the
compiled-default sweep (``tests/unittests/analysis/test_compiled_default_path.py``
``CASES``) that the JAX manifest certifies for the pool is driven through a
64-stream pool, with the JAX test's schedule: one micro-batch of all 64
streams, then resets of 8 tenants and a detach/attach churn of 8 more, then a
second 64-stream micro-batch; ``compute_all()`` must give each surviving
stream its eager twin's value (counts bit for bit, floats at the JAX sweep's
``rtol=1e-4, atol=1e-6``). The same seeded numpy batches go through the JAX
package's pool, and the two pools must agree at the same tolerance. As in
the JAX test, the whole sweep runs with the lock sanitizer armed and ends
with no recorded violation. Added for the port: ``predicted_stream_bytes()`` equals
the bytes of one stream's real stacked rows for every pooled class, and the
checked-in ``_memory.json`` and ``_eligibility.json`` are what
``tools/port_memory_manifest.py`` writes from the port's classes today.
"""

import importlib.util
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as TM
from tests.unittests.analysis.test_compiled_default_path import CASES
from torchmetrics_tpu._analysis.manifest import stream_pool_eligible as jax_stream_pool_eligible
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch import aggregation as TA
from torchmetrics_tpu_torch._streams.manifest import stream_pool_eligible

N_STREAMS = 64
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _locksan_armed():
    """Every pool's StreamLabeler, and the process singletons it publishes telemetry through, hold the declared
    guard map live: zero recorded violations at module teardown."""
    from torchmetrics_tpu_torch._analysis import locksan

    locksan.set_locksan_enabled(True)
    locksan.reset()
    yield
    try:
        assert locksan.violations() == [], locksan.violations()
    finally:
        locksan.set_locksan_enabled(False)
        locksan.reset()


def _jax_sweep():
    return [name for name, (ctor, _) in sorted(CASES.items()) if jax_stream_pool_eligible(type(ctor())) in ("safe", "runtime")]


SWEEP = _jax_sweep()


def _port_ctor(name):
    """The port's class of the JAX case, with the JAX instance's class-count arguments."""
    jm = CASES[name][0]()
    cls = getattr(TM, name, None) or getattr(TA, name)
    kwargs = {k: getattr(jm, k) for k in ("num_classes", "num_labels", "num_groups") if getattr(jm, k, None) is not None}
    if name == "MinkowskiDistance":
        kwargs = {"p": 3.0}
    return lambda **kw: cls(device="cpu", **kwargs, **kw)


def _numpy(args):
    return tuple(np.asarray(a) for a in args)


def _leaves(value):
    """A computed value's arrays in a fixed order (dict keys sorted), as float64 numpy, with their kinds."""
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _leaves(value[k])]
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _leaves(v)]
    if isinstance(value, torch.Tensor):
        return [(value.numpy(), value.is_floating_point())]
    arr = np.asarray(value)
    return [(arr, np.issubdtype(arr.dtype, np.floating))]


def _agree(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for (a, a_float), (b, _) in zip(g, w):
        if a_float:
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=RTOL, atol=ATOL, err_msg=what)
        else:  # counts: bit for bit
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


def test_sweep_covers_the_jax_population():
    assert len(SWEEP) == 41, SWEEP
    # the port's gate certifies exactly the classes the JAX gate does
    assert [n for n in SWEEP if stream_pool_eligible(type(_port_ctor(n)())) in ("safe", "runtime")] == SWEEP


def _schedule(ctor, stack, batches1, batches2):
    """The JAX sweep's schedule on one package: returns ``(compute_all, final ids)``."""
    pool = ctor().to_stream_pool(capacity=N_STREAMS)
    for _ in range(N_STREAMS):
        pool.attach()
    ids = np.arange(N_STREAMS, dtype=np.int32)
    pool.update(ids, *stack(batches1))
    for sid in range(0, 8):
        pool.reset(sid)
    for sid in range(8, 16):
        pool.detach(sid)
    new = [pool.attach() for _ in range(8)]
    assert new == list(range(8, 16))  # the freed slots are recycled lowest-first
    pool.update(ids, *stack(batches2))
    return pool, pool.compute_all()


@pytest.mark.parametrize("name", SWEEP)
def test_pool_matches_eager_64_streams(name):
    jax_ctor, maker = CASES[name]
    port_ctor = _port_ctor(name)
    batches1 = [_numpy(maker()) for _ in range(N_STREAMS)]
    batches2 = [_numpy(maker()) for _ in range(N_STREAMS)]

    def torch_stack(batches):
        return tuple(torch.from_numpy(np.stack([b[i] for b in batches])) for i in range(len(batches[0])))

    def jax_stack(batches):
        return tuple(jax.numpy.asarray(np.stack([b[i] for b in batches])) for i in range(len(batches[0])))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pool, got = _schedule(port_ctor, torch_stack, batches1, batches2)
        # the eager twins: round 1 for the streams that keep their history, round 2 for all
        eagers = {}
        for sid in range(N_STREAMS):
            m = port_ctor(auto_compile=False)
            if sid >= 16:
                m.update(*(torch.from_numpy(a) for a in batches1[sid]))
            m.update(*(torch.from_numpy(a) for a in batches2[sid]))
            eagers[sid] = m
        _, jax_got = _schedule(jax_ctor, jax_stack, batches1, batches2)
    assert sorted(got) == sorted(eagers) == sorted(jax_got)
    for sid in range(N_STREAMS):
        _agree(got[sid], eagers[sid].compute(), f"{name}[{sid}] pool vs eager")
        _agree(got[sid], jax.tree_util.tree_map(np.asarray, jax_got[sid]), f"{name}[{sid}] port pool vs JAX pool")
    # the single-slot compute agrees with the vmapped one
    _agree(pool.compute(3), got[3], f"{name}[3] compute vs compute_all")


def test_pool_facet_consistent_with_update_verdicts():
    """Pool-eligible classes are exactly the traceable-update, traceable-compute population."""
    import json
    from pathlib import Path

    facets = json.loads((Path(_compile.__file__).with_name("_eligibility.json")).read_text())["in_graph_sync"]
    for name in SWEEP:
        cls = type(_port_ctor(name)())
        qual = f"{cls.__module__}.{cls.__qualname__}"
        assert _compile.eligibility_verdict(cls) in ("metadata_only", "value_flags"), name
        assert facets.get(qual) not in (None, "host_bound"), name


def _stacked_row_bytes(pool):
    total = sum(t.nbytes for t in pool._defaults.values())
    assert total % pool.physical == 0
    return total // pool.physical


@pytest.mark.parametrize("name", SWEEP)
def test_predicted_stream_bytes_equals_the_stacked_rows(name):
    """The memory model, priced in the port's dtypes, is one stream's real rows (an int64 count is 8 bytes)."""
    pool = _port_ctor(name)().to_stream_pool(capacity=3)
    sid = pool.attach()
    batch = _numpy(CASES[name][1]())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pool.update([sid], *(torch.from_numpy(a[None]) for a in batch))
    assert pool.predicted_stream_bytes() == _stacked_row_bytes(pool)


def test_predicted_stream_bytes_of_a_ring_state_and_a_collection():
    ring = TM.CatMetric(device="cpu", cat_state_capacity=7, nan_strategy="disable").to_stream_pool(capacity=2)
    sid = ring.attach()
    ring.update([sid], torch.ones((1, 3)))
    assert ring.predicted_stream_bytes() == _stacked_row_bytes(ring) == 7 * (4 + 1) + 8
    group = TM.MetricCollection(
        [TM.MulticlassAccuracy(num_classes=5, device="cpu"), TM.MulticlassPrecision(num_classes=5, device="cpu"),
         TM.MulticlassConfusionMatrix(num_classes=5, device="cpu")]
    ).to_stream_pool(capacity=2)
    sid = group.attach()
    group.update([sid], torch.rand(1, 6, 5), torch.randint(0, 5, (1, 6)))
    # accuracy and precision share one group's rows: only the heads' states are stacked
    assert len(group._units) == 2
    assert group.predicted_stream_bytes() == _stacked_row_bytes(group) == 4 * 5 * 4 + 5 * 5 * 4


def test_the_checked_in_admission_copies_are_what_the_tool_writes():
    """A state whose dtype changes in the port changes its bytes: the checked-in formulas must follow at once."""
    path = Path(__file__).resolve().parents[1] / "tools" / "port_memory_manifest.py"
    spec = importlib.util.spec_from_file_location("port_memory_manifest", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eligibility, memory, _, _ = tool.payloads()
    stale = "is stale: run `python tools/port_memory_manifest.py` again"
    assert tool.dump(memory) == (tool.PORT / "_memory.json").read_text(), f"_memory.json {stale}"
    assert tool.dump(eligibility) == (tool.PORT / "_eligibility.json").read_text(), f"_eligibility.json {stale}"
    assert json.loads(tool.dump(memory))["classes"], "the copy holds no class"
