"""The certified default path through both packages, the port's eligibility copy, and ``ring_push``.

The 16 classes of ``torchmetrics_tpu/_aot/default_path.py`` are built at
their constructor defaults in both packages and fed the same canonical
32-row batch three times, as ``drive_default_path`` does: the port's compiled
path must engage exactly where the JAX instance has ``_auto_update_fn``, and
``compute()`` must agree (counts exactly, float results within 1e-6).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as TM
from torchmetrics_tpu._aot.default_path import DEFAULT_PATH_CASES, canonical_batch
from torchmetrics_tpu.utilities.ringbuffer import ring_push as jax_ring_push
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch.utilities import ring_push

REPO = Path(__file__).resolve().parents[1]
NAMES = sorted(DEFAULT_PATH_CASES.keys())


@pytest.mark.parametrize("name", NAMES)
def test_default_path_engages_where_the_jax_package_does(name):
    ctor, _ = DEFAULT_PATH_CASES[name]
    jm = ctor()
    ported = getattr(TM, name)
    kwargs = {k: getattr(jm, k) for k in ("num_classes", "num_labels") if hasattr(jm, k)}
    tm = ported(device="cpu", **kwargs)
    batch = [np.asarray(a) for a in canonical_batch(name)]
    for _ in range(3):
        jm.update(*(jnp.asarray(a) for a in batch))
        tm.update(*(torch.from_numpy(a) for a in batch))
    jax_engaged = "_auto_update_fn" in jm.__dict__ and not jm._auto_disabled
    port_engaged = bool(tm.__dict__.get("_auto_update_fn")) and not tm._auto_disabled
    assert port_engaged == jax_engaged, (name, tm._auto_disabled_reason)
    got, want = tm.compute(), jm.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    eager = ported(device="cpu", auto_compile=False, **kwargs)
    for _ in range(3):
        eager.update(*(torch.from_numpy(a) for a in batch))
    assert torch.equal(got, eager.compute()), name


def test_eligibility_copy_equals_the_jax_verdicts():
    jax_classes = json.loads((REPO / "torchmetrics_tpu/_analysis/eligibility.json").read_text())["classes"]
    ported = json.loads((REPO / "torchmetrics_tpu_torch/_eligibility.json").read_text())["classes"]
    want = {q.replace("torchmetrics_tpu.", "torchmetrics_tpu_torch.", 1): v["verdict"] for q, v in jax_classes.items()}
    assert ported == want
    counts = {v: list(ported.values()).count(v) for v in set(ported.values())}
    assert counts == {"metadata_only": 57, "value_flags": 29, "host_bound": 118}
    # every name is a class of the port, under its own module path and qualname
    import importlib

    for qualname, verdict in ported.items():
        module, _, cls_name = qualname.rpartition(".")
        cls = getattr(importlib.import_module(module), cls_name)
        assert _compile.eligibility_verdict(cls) == verdict


@pytest.mark.parametrize(("capacity", "count", "rows"), [(8, 0, 3), (8, 6, 5), (8, 3, 20), (5, 12, 5), (4, 0, 4)])
def test_ring_push_equals_the_jax_ring_push(capacity, count, rows):
    rng = np.random.default_rng(capacity * 100 + count * 10 + rows)
    data = rng.standard_normal((capacity, 3)).astype(np.float32)
    valid = rng.random(capacity) < 0.5
    batch = rng.standard_normal((rows, 3)).astype(np.float32)
    jd, jv, jc = jax_ring_push(jnp.asarray(data), jnp.asarray(valid), jnp.int32(count), jnp.asarray(batch))
    td, tv, tc = ring_push(torch.from_numpy(data), torch.from_numpy(valid), torch.tensor(count, dtype=torch.int32),
                           torch.from_numpy(batch))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tc) == int(jc) == count + rows
