"""The port's recompile gate (``tests/unittests/analysis/test_recompile_gate.py``): the certified default path
on the CPU builds EXACTLY the keys pinned by ``torchmetrics_tpu_torch/_compile_golden.json``.

Driving the canonical sweep (``torchmetrics_tpu_torch/_aot/default_path.py``)
must produce no compiled-step key beyond the manifest: a change that perturbs
argument structure, static values, shapes, dtypes, devices, layouts or the
dtype policy fails with the churn detector naming the component that moved.
Staleness runs both ways (regenerate with
``python -m torchmetrics_tpu_torch._aot golden --write``). The sweep's
batches are the JAX package's, value for value, and the manifest's keys
agree with the JAX manifest's on every component both packages keep.
"""

import ast

import numpy as np
import pytest
import torch

from torchmetrics_tpu._aot.default_path import canonical_batch as jax_canonical_batch
from torchmetrics_tpu._aot.golden import load_golden as jax_load_golden
from torchmetrics_tpu_torch._aot.default_path import (
    DEFAULT_PATH_CASES,
    canonical_batch,
    collect_compile_keys,
    drive_default_path,
)
from torchmetrics_tpu_torch._aot.golden import GOLDEN_PATH, check_observed, load_golden

JAX_COMPONENTS = {"arg_structure", "static_args", "shapes", "dtypes", "dtype_policy"}


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def observed():
    return drive_default_path(device="cpu")


def test_golden_manifest_checked_in_and_nontrivial(golden):
    assert GOLDEN_PATH.exists()
    assert len(golden) >= 12, "the certified sweep must span a cross-family slice"
    for name, entries in golden.items():
        assert entries, f"{name}: golden manifest entry with no compile keys"
        for e in entries:
            assert set(e["components"]) >= JAX_COMPONENTS | {"devices", "layouts"}


def test_certified_default_path_zero_compiles_beyond_golden(observed, golden):
    problems = check_observed(observed, golden)
    assert not problems, "recompile gate failed:\n" + "\n".join(f"  - {p}" for p in problems)


def test_every_swept_class_actually_compiled(observed):
    for name, entries in observed.items():
        kinds = {e["kind"] for e in entries}
        assert "auto_update" in kinds, f"{name}: default path never reported an auto_update compile"


def test_gate_names_broken_dtype_policy_component(golden):
    """Breaking a cache-key component in a fixture sweep fails the gate, the churn detector NAMING it."""
    from torchmetrics_tpu_torch._observability.state import OBS

    ctor, _ = DEFAULT_PATH_CASES["MeanSquaredError"]
    args = canonical_batch("MeanSquaredError", "cpu")
    was = OBS.enabled
    OBS.enabled = True
    try:
        metric = ctor(device="cpu")
        metric.set_dtype(torch.float16)  # the fixture's deliberate breakage
        for _ in range(3):
            metric.update(*args)
        broken = {"MeanSquaredError": collect_compile_keys(metric)}
    finally:
        OBS.enabled = was
    problems = check_observed(broken, {"MeanSquaredError": golden["MeanSquaredError"]})
    assert problems, "the gate must fail on a perturbed cache-key component"
    text = "\n".join(problems)
    assert "dtype_policy" in text, text
    assert "NEW `auto_update` compile beyond the golden manifest" in text


def test_gate_names_broken_shape_component(golden):
    from torchmetrics_tpu_torch._observability.state import OBS

    ctor, _ = DEFAULT_PATH_CASES["BinaryAccuracy"]
    preds, target = canonical_batch("BinaryAccuracy", "cpu")
    was = OBS.enabled
    OBS.enabled = True
    try:
        metric = ctor(device="cpu")
        for _ in range(3):
            metric.update(preds[:17], target[:17])  # off-manifest batch shape
        broken = {"BinaryAccuracy": collect_compile_keys(metric)}
    finally:
        OBS.enabled = was
    problems = check_observed(broken, {"BinaryAccuracy": golden["BinaryAccuracy"]})
    text = "\n".join(problems)
    assert "shapes" in text, text


def test_stale_manifest_direction_reported(golden):
    observed = {"MeanSquaredError": []}  # the sweep "lost" its compile keys
    problems = check_observed(observed, {"MeanSquaredError": golden["MeanSquaredError"]})
    assert any("stale manifest" in p for p in problems)


@pytest.mark.parametrize("name", sorted(DEFAULT_PATH_CASES))
def test_canonical_batch_equals_the_jax_package(name):
    """The same seed and draws: every array equal value for value (labels int64 here, int32 in JAX)."""
    ours, theirs = canonical_batch(name, "cpu"), jax_canonical_batch(name)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.shape == b.shape
        if b.dtype.kind == "f":
            assert a.dtype == torch.float32 and b.dtype == np.float32
        else:
            assert a.dtype == torch.int64 and b.dtype.kind == "i"
        np.testing.assert_array_equal(a.numpy(), b)


def test_manifest_agrees_with_the_jax_manifest(golden):
    """Same classes, kinds, shapes, static arguments and dtype policy as the JAX package's manifest."""
    theirs = jax_load_golden()
    assert set(golden) == set(theirs)
    for name in golden:
        ours_keys = sorted((e["kind"], e["components"]["shapes"], e["components"]["static_args"],
                            e["components"]["dtype_policy"]) for e in golden[name])
        jax_keys = sorted((e["kind"], e["components"]["shapes"], e["components"]["static_args"],
                           e["components"]["dtype_policy"]) for e in theirs[name])
        assert ours_keys == jax_keys, name
        for ours, jax in zip(golden[name], theirs[name]):
            ours_dtypes = ast.literal_eval(ours["components"]["dtypes"])
            jax_dtypes = ast.literal_eval(jax["components"]["dtypes"])
            assert [d.replace("int64", "int32") for d in ours_dtypes] == list(jax_dtypes), name
