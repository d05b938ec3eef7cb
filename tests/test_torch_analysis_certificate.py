"""The R1 certificate in ``Metric``'s eager update, and the faults the port's lint found, on the CPU.

A certified class's eager update skips the host-attribute fingerprint and
counts ``fingerprint|outcome=skip``, as the JAX package's does; with the skip
turned off it counts ``check`` and leaves its states bit for bit the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu._observability as JO
import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch._observability as PO
from torchmetrics_tpu._analysis import manifest as jax_manifest
from torchmetrics_tpu_torch._analysis import manifest as port_manifest

pytestmark = pytest.mark.filterwarnings("ignore:.*is recompiling its")

# every batch size differs, so every update is a signature's first sighting and runs eagerly
SIZES = (5, 7, 9, 11, 13)


def _batches(kind, seed=0):
    rng = np.random.default_rng(seed)
    for n in SIZES:
        if kind == "confmat":
            yield rng.integers(0, 7, n), rng.integers(0, 7, n)
        else:
            yield rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)


CASES = {
    "mse": (lambda pkg, kw: pkg.MeanSquaredError(**kw), "reg"),
    "confmat": (lambda pkg, kw: pkg.classification.MulticlassConfusionMatrix(num_classes=7, **kw), "confmat"),
    "pearson": (lambda pkg, kw: pkg.PearsonCorrCoef(**kw), "reg"),
    "csi": (lambda pkg, kw: pkg.CriticalSuccessIndex(threshold=0.0, **kw), "reg"),
    "explained_variance": (lambda pkg, kw: pkg.ExplainedVariance(**kw), "reg"),
}


@pytest.fixture()
def telemetry():
    for obs in (JO, PO):
        obs.REGISTRY.reset()
        obs.set_telemetry_enabled(True)
    yield
    for obs in (JO, PO):
        obs.set_telemetry_enabled(False)
        obs.REGISTRY.reset()
    for m in (jax_manifest, port_manifest):
        m.set_fingerprint_skip_enabled(True)


def _run(pkg, name, skip, conv, kw):
    (jax_manifest if pkg is J else port_manifest).set_fingerprint_skip_enabled(skip)
    ctor, kind = CASES[name]
    metric = ctor(pkg, kw)
    for a, b in _batches(kind):
        metric.update(conv(a), conv(b))
    return metric, metric.telemetry_report()


def _port(name, skip):
    return _run(P, name, skip, torch.from_numpy, {"device": "cpu"})


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_certified_class_skips_the_fingerprint_as_the_jax_package_does(name, telemetry):
    metric, rep = _port(name, True)
    _, jrep = _run(J, name, True, jnp.asarray, {})
    eager = rep.path_counts["eager"]
    assert eager == len(SIZES)
    assert rep.counter("fingerprint|outcome=skip") == eager and rep.counter("fingerprint|outcome=check") == 0
    assert jrep.counter("fingerprint|outcome=skip") == rep.counter("fingerprint|outcome=skip")
    assert jrep.counter("fingerprint|outcome=check") == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_skipping_the_fingerprint_leaves_the_states_bit_for_bit(name, telemetry):
    skipped, rep = _port(name, True)
    checked, rep_off = _port(name, False)
    assert rep_off.counter("fingerprint|outcome=check") == len(SIZES) and rep_off.counter("fingerprint|outcome=skip") == 0
    assert rep.counter("fingerprint|outcome=skip") == len(SIZES)
    for state in skipped._defaults:
        a, b = getattr(skipped, state), getattr(checked, state)
        if isinstance(a, list):
            assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), state


def test_a_user_subclass_keeps_the_guard(telemetry):
    class Mine(P.MeanSquaredError):
        pass

    metric = Mine(device="cpu")
    for a, b in _batches("reg"):
        metric.update(torch.from_numpy(a), torch.from_numpy(b))
    rep = metric.telemetry_report()
    assert rep.counter("fingerprint|outcome=check") == len(SIZES) and rep.counter("fingerprint|outcome=skip") == 0


def test_a_guarded_update_still_catches_a_plain_attribute_mutation():
    """The certificate removes the guard only where R1 proved it redundant: an uncertified class still trips it."""

    class Leaky(P.MeanSquaredError):
        def update(self, preds, target):
            super().update(preds, target)
            self.seen = getattr(self, "seen", 0) + 1

    metric = Leaky(device="cpu")
    for a, b in _batches("reg"):
        metric.update(torch.from_numpy(a), torch.from_numpy(b))
    assert not metric._auto_eligible()


@pytest.mark.parametrize("ties", [False, True])
def test_kendall_tau_c_counts_distinct_values_on_the_device(ties):
    """C13: tau-c counted the distinct values with two ``torch.unique(...).numel()`` host reads; it now counts them
    on the device (sorted neighbours differ), as the JAX package's pairwise count does, and agrees with it."""
    from torchmetrics_tpu_torch.functional.regression.kendall import _distinct_count

    rng = np.random.default_rng(3)
    p = rng.integers(0, 5, 40).astype(np.float32) if ties else rng.standard_normal(40).astype(np.float32)
    t = rng.integers(0, 3, 40).astype(np.float32) if ties else rng.standard_normal(40).astype(np.float32)
    got = P.functional.kendall_rank_corrcoef(torch.from_numpy(p), torch.from_numpy(t), variant="c")
    want = J.functional.kendall_rank_corrcoef(jnp.asarray(p), jnp.asarray(t), variant="c")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert int(_distinct_count(torch.from_numpy(p))) == len(np.unique(p))
    # no host read: it runs under vmap, one count a row
    rows = torch.from_numpy(np.stack([p, t]))
    counts = torch.func.vmap(_distinct_count)(rows)
    assert counts.tolist() == [len(np.unique(p)), len(np.unique(t))]
