"""The fleet wire between the two packages.

A contribution encoded by the JAX package decodes and folds in a port node,
and the reverse: the payload holds host numpy and the same integrity block
in both packages. Each direction must reach the JAX fold's value (a JAX
contribution folded by a JAX node, on the same numpy rows): ``MeanMetric``
and ``SumMetric`` as the fleet suite ships them, and ``MeanSquaredError``
and ``MulticlassConfusionMatrix``, whose integer counts are int64 in the
port where the JAX package keeps int32 (``ROADMAP.md`` §C): a count
loads as the receiving metric's own integer dtype after its checksum is
verified on what came in, so those fold as well.
"""

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from tests.test_torch_fleet_transport import JAX, PORT, holds_no_tensor, value

CASES = {
    "MeanMetric": (lambda S: S.agg.MeanMetric(**S.kw), lambda rng: [rng.normal(size=8).astype(np.float32)]),
    "SumMetric": (lambda S: S.agg.SumMetric(**S.kw), lambda rng: [rng.normal(size=8).astype(np.float32)]),
    "MeanSquaredError": (
        lambda S: (jtm if S is JAX else ttm).regression.MeanSquaredError(**S.kw),
        lambda rng: [rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)],
    ),
    "MulticlassConfusionMatrix": (
        lambda S: (jtm if S is JAX else ttm).classification.MulticlassConfusionMatrix(num_classes=6, **S.kw),
        lambda rng: [rng.integers(0, 6, 32), rng.integers(0, 6, 32)],
    ),
}


def _fold(sender, receiver, name, batches):
    """Encode ``batches`` in ``sender``'s package, fold them in a ``receiver`` node (with a first row of its own)."""
    make, _ = CASES[name]
    m = make(sender)
    for args in batches[1:]:
        m.update(*(sender.arr(a) for a in args))
    blob, digest = sender.fleet.encode_contribution(m, "edge-00", 0, (("edge-00", 0),))
    kv = receiver.fleet.InProcessKV()
    node = receiver.fleet.AggregationNode("region-00", make(receiver), kv, children=("edge-00",), namespace="w",
                                          deadline_s=0.5)
    node.metric.update(*(receiver.arr(a) for a in batches[0]))
    kv.set(receiver.fleet.contribution_key("w", "edge-00", 0, digest), blob)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = node.rollup(0)
    assert not r.partial and r.corrupt_quarantined == 0 and r.contributing == (("edge-00", 0),), r.details
    assert node.folded_sources == {("edge-00", 0)}
    return node.metric.compute(), blob


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_contribution_folds_across_packages(name, direction):
    rng = np.random.default_rng(17)
    batches = [CASES[name][1](rng) for _ in range(4)]
    want, _ = _fold(JAX, JAX, name, batches)
    sender, receiver = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    got, blob = _fold(sender, receiver, name, batches)
    np.testing.assert_allclose(value(got), value(want), rtol=1e-5, atol=1e-6)
    # what either package put on the wire decodes in both, as host values
    for S in (JAX, PORT):
        states = S.fleet.decode_contribution(blob).states
        assert holds_no_tensor(states)
        assert "#integrity" in states
