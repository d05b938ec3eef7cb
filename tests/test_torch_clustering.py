"""The port's clustering metrics on the CPU, against the JAX package.

Every functional and class and the four utilities, on the same seeded numpy
labels: random, with gaps and negatives, one cluster, all singletons, and
two equal clusterings. Float32 values agree within ``RTOL``/``ATOL``: the
same float32 formulas, summed in another order.

The expected mutual information is the one number computed differently. The
JAX package's host loop takes log-gamma of the float32 marginals, which
moves its EMI by up to ~4e-5 relative to float64 at these sizes; the port
sums the same terms in float64 throughout. So the port's EMI is held within
``EMI_RTOL`` to the JAX loop run on the float64 contingency, and its AMI
within ``AMI_ATOL`` to the JAX AMI's formula with that EMI; against the JAX
package's own AMI it is held within ``AMI_JAX_ATOL``, the float32 log-gamma's
share. The loop is slow, so these cases stay at K <= 12.
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.clustering as JC
import torchmetrics_tpu.functional.clustering as JF
import torchmetrics_tpu_torch.clustering as PC
import torchmetrics_tpu_torch.functional.clustering as PF

jax_extrinsic = importlib.import_module("torchmetrics_tpu.functional.clustering.extrinsic")
extrinsic = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.extrinsic")
intrinsic = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.intrinsic")

RTOL = 1e-5
ATOL = 1e-6
EMI_RTOL = 1e-10
AMI_ATOL = 1e-6
AMI_JAX_ATOL = 1e-4
EXTRINSIC = [
    "mutual_info_score", "normalized_mutual_info_score", "adjusted_mutual_info_score", "rand_score",
    "adjusted_rand_score", "homogeneity_score", "completeness_score", "v_measure_score", "fowlkes_mallows_index",
]
LABEL_SETS = ["random", "gaps_negatives", "one_cluster", "singletons", "equal"]


def labels(kind, seed=0, n=60):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 5, n), rng.integers(0, 4, n)
    if kind == "gaps_negatives":
        return rng.choice([-7, -1, 3, 10, 42], n), rng.choice([-2, 5, 9], n)
    if kind == "one_cluster":
        return np.zeros(n, dtype=np.int64), rng.integers(0, 3, n)
    if kind == "singletons":
        return rng.permutation(n), rng.integers(0, 6, n)
    x = rng.integers(0, 6, n)
    return x, x.copy()


def both(name, *arrays, **kwargs):
    got = getattr(PF, name)(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
    want = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    return got, np.asarray(want)


@pytest.mark.parametrize("name", EXTRINSIC)
@pytest.mark.parametrize("kind", LABEL_SETS)
def test_extrinsic_matches_jax(name, kind):
    preds, target = labels(kind, seed=len(name))
    got, want = both(name, preds, target)
    assert got.dtype == torch.float32 and got.ndim == 0
    atol = AMI_JAX_ATOL if name == "adjusted_mutual_info_score" else ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("average_method", ["min", "max", "arithmetic", "geometric"])
@pytest.mark.parametrize("name", ["normalized_mutual_info_score", "adjusted_mutual_info_score"])
def test_average_methods(name, average_method):
    preds, target = labels("random", seed=3)
    got, want = both(name, preds, target, average_method=average_method)
    atol = AMI_JAX_ATOL if name == "adjusted_mutual_info_score" else ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("beta", [0.5, 1.0, 2.0])
def test_v_measure_beta(beta):
    preds, target = labels("random", seed=4)
    got, want = both("v_measure_score", preds, target, beta=beta)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(("n", "k_pred", "k_true", "chunk_terms"), [(40, 3, 4, None), (300, 12, 12, None),
                                                                    (300, 12, 12, 50), (500, 2, 9, 7)])
def test_expected_mutual_info_is_the_jax_loop_in_float64(n, k_pred, k_true, chunk_terms, monkeypatch):
    """The chunked ragged sum equals the JAX loop on exact marginals; row chunks forced small where given."""
    if chunk_terms is not None:
        monkeypatch.setattr(extrinsic, "_EMI_CHUNK_TERMS", chunk_terms)
    rng = np.random.default_rng(n + k_pred)
    preds, target = rng.integers(0, k_pred, n), rng.integers(0, k_true, n)
    contingency = JF.calculate_contingency_matrix(jnp.asarray(preds), jnp.asarray(target))
    want = jax_extrinsic.expected_mutual_info_score(np.asarray(contingency, np.float64), n)
    got = extrinsic.expected_mutual_info_score(PF.calculate_contingency_matrix(torch.from_numpy(preds),
                                                                                torch.from_numpy(target)), n)
    assert abs(got - want) <= EMI_RTOL * abs(want)
    # the JAX package's own loop, on float32 marginals: within its float32 log-gamma
    jax_own = jax_extrinsic.expected_mutual_info_score(contingency, n)
    assert abs(got - jax_own) <= 1e-4 * abs(want)

    # AMI: the JAX formula with the float64 EMI
    mi = np.asarray(JF.mutual_info_score(jnp.asarray(preds), jnp.asarray(target)))
    norm = float(np.mean([np.asarray(JF.calculate_entropy(jnp.asarray(preds))),
                          np.asarray(JF.calculate_entropy(jnp.asarray(target)))]))
    ami = PF.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target))
    assert abs(float(ami) - (float(mi) - want) / (norm - want)) <= AMI_ATOL


def test_ami_when_both_clusterings_are_one_cluster():
    """MI, both entropies and the exact EMI are 0, so AMI takes the JAX package's ``|denom| < 1e-15`` return: 0.

    The JAX package itself returns 1.0 here: its float32 ``log(a_i)`` leaves
    an EMI of ~1e-8 instead of 0, and AMI becomes ``-EMI / -EMI``. A
    divergence by design, listed in ROADMAP.md.
    """
    zeros = np.zeros(20, dtype=np.int64)
    contingency = JF.calculate_contingency_matrix(jnp.asarray(zeros), jnp.asarray(zeros))
    assert jax_extrinsic.expected_mutual_info_score(np.asarray(contingency, np.float64), 20) == 0.0
    assert 0.0 < abs(jax_extrinsic.expected_mutual_info_score(contingency, 20)) < 1e-6
    assert extrinsic.expected_mutual_info_score(torch.ones((1, 1)) * 20, 20) == 0.0
    got = PF.adjusted_mutual_info_score(torch.from_numpy(zeros), torch.from_numpy(zeros))
    assert got.dtype == torch.float32 and float(got) == 0.0


@pytest.mark.parametrize("kind", LABEL_SETS)
def test_contingency_and_pair_confusion_matrix(kind):
    preds, target = labels(kind, seed=7)
    got, want = both("calculate_contingency_matrix", preds, target)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got, want = both("calculate_contingency_matrix", preds, target, eps=0.25)
    np.testing.assert_array_equal(got.numpy(), want)
    got, want = both("calculate_pair_cluster_confusion_matrix", preds, target)
    assert got.shape == (2, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # from a given contingency, with its [0, 1] entry from the row marginals
    contingency = PF.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    from_matrix = PF.calculate_pair_cluster_confusion_matrix(contingency=contingency)
    np.testing.assert_array_equal(from_matrix.numpy(), want)


def test_sparse_contingency_is_a_torch_sparse_tensor():
    preds, target = labels("gaps_negatives", seed=8)
    got = PF.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target), sparse=True)
    want = JF.calculate_contingency_matrix(jnp.asarray(preds), jnp.asarray(target), sparse=True)
    assert got.is_sparse
    np.testing.assert_array_equal(got.to_dense().numpy(), want.toarray())
    with pytest.raises(ValueError, match="Cannot specify `eps` and return sparse tensor"):
        PF.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target), eps=1e-3, sparse=True)


@pytest.mark.parametrize("kind", LABEL_SETS)
def test_entropy(kind):
    got, want = both("calculate_entropy", labels(kind, seed=9)[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", ["min", "max", "arithmetic", "geometric", 2.0, -1.5, 0.5])
def test_generalized_mean(p):
    x = np.abs(np.random.default_rng(10).normal(size=5)).astype(np.float32) + 0.5
    got, want = both("calculate_generalized_mean", x, p=p)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="Invalid generalized mean"):
        PF.calculate_generalized_mean(torch.from_numpy(x), "harmonic")


def test_label_checks():
    with pytest.raises(ValueError, match="Expected 1d arrays"):
        PF.rand_score(torch.zeros((2, 3), dtype=torch.int64), torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="same shape"):
        PF.mutual_info_score(torch.zeros(3, dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="Expected 2D data"):
        PF.calinski_harabasz_score(torch.zeros(4), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="Expected 1D labels"):
        PF.davies_bouldin_score(torch.zeros((4, 2)), torch.zeros((4, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="same number of samples"):
        PF.dunn_index(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int64))


def cluster_data(kind, seed=0, n=80, d=6):
    rng = np.random.default_rng(seed)
    if kind == "separated":
        lab = rng.integers(0, 4, n)
        return (rng.normal(size=(n, d)) + 5.0 * lab[:, None]).astype(np.float32), lab
    if kind == "overlapping":
        return rng.normal(size=(n, d)).astype(np.float32), rng.integers(0, 7, n)
    lab = rng.choice([-3, 2, 11], n)
    lab[0] = 99  # a singleton cluster
    return rng.normal(size=(n, d)).astype(np.float32), lab


@pytest.mark.parametrize("tile_bytes", [None, 64])
@pytest.mark.parametrize("kind", ["separated", "overlapping", "singleton_cluster"])
@pytest.mark.parametrize(("name", "kwargs"), [("calinski_harabasz_score", {}), ("davies_bouldin_score", {}),
                                              ("dunn_index", {}), ("dunn_index", {"p": 1.0}),
                                              ("dunn_index", {"p": 3.0})])
def test_intrinsic_matches_jax(name, kwargs, kind, tile_bytes, monkeypatch):
    """With ``tile_bytes`` the centroid pairs go one row a tile: the tiled path is the one compared."""
    if tile_bytes is not None:
        monkeypatch.setattr(intrinsic, "_TILE_BYTES", tile_bytes)
    data, lab = cluster_data(kind, seed=len(name))
    got, want = both(name, data, lab, **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


CLASSES = ["MutualInfoScore", "NormalizedMutualInfoScore", "AdjustedMutualInfoScore", "RandScore",
           "AdjustedRandScore", "HomogeneityScore", "CompletenessScore", "VMeasureScore", "FowlkesMallowsIndex"]


@pytest.mark.parametrize("name", CLASSES)
def test_extrinsic_classes_stream_merge_and_pickle(name):
    preds, target = labels("gaps_negatives", seed=11, n=90)
    ours, theirs = getattr(PC, name)(device="cpu"), getattr(JC, name)()
    for lo in range(0, 90, 30):
        ours.update(torch.from_numpy(preds[lo:lo + 30]), torch.from_numpy(target[lo:lo + 30]))
        theirs.update(jnp.asarray(preds[lo:lo + 30]), jnp.asarray(target[lo:lo + 30]))
    atol = AMI_JAX_ATOL if name == "AdjustedMutualInfoScore" else ATOL
    got = ours.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.compute()), rtol=RTOL, atol=atol)
    # the generated class pickles by its module path, states included
    restored = pickle.loads(pickle.dumps(ours))
    assert type(restored) is type(ours) and type(ours).__module__ == "torchmetrics_tpu_torch.clustering"
    assert float(restored.compute()) == float(got)
    # merge_state of two halves: the cat states concatenate
    first, second = getattr(PC, name)(device="cpu"), getattr(PC, name)(device="cpu")
    first.update(torch.from_numpy(preds[:45]), torch.from_numpy(target[:45]))
    second.update(torch.from_numpy(preds[45:]), torch.from_numpy(target[45:]))
    first.merge_state(second)
    assert float(first.compute()) == float(got)


def test_class_keyword_settings():
    preds, target = labels("random", seed=12)
    nmi = PC.NormalizedMutualInfoScore(average_method="min", device="cpu")
    vm = PC.VMeasureScore(beta=2.0, device="cpu")
    for metric in (nmi, vm):
        metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_allclose(nmi.compute().numpy(), both("normalized_mutual_info_score", preds, target,
                                                          average_method="min")[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vm.compute().numpy(), both("v_measure_score", preds, target, beta=2.0)[1],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(("name", "kwargs"), [("CalinskiHarabaszScore", {}), ("DaviesBouldinScore", {}),
                                              ("DunnIndex", {}), ("DunnIndex", {"p": 1.0})])
def test_intrinsic_classes_stream(name, kwargs):
    data, lab = cluster_data("separated", seed=13, n=90)
    ours, theirs = getattr(PC, name)(device="cpu", **kwargs), getattr(JC, name)(**kwargs)
    for lo in range(0, 90, 30):
        ours.update(torch.from_numpy(data[lo:lo + 30]), torch.from_numpy(lab[lo:lo + 30]))
        theirs.update(jnp.asarray(data[lo:lo + 30]), jnp.asarray(lab[lo:lo + 30]))
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=RTOL, atol=ATOL)
    assert ours.higher_is_better == theirs.higher_is_better
    restored = pickle.loads(pickle.dumps(ours))
    np.testing.assert_array_equal(restored.compute().numpy(), ours.compute().numpy())


def test_exports_and_flags():
    assert sorted(PC.__all__) == sorted(JC.__all__) and sorted(PF.__all__) == sorted(JF.__all__)
    for name in CLASSES:
        assert getattr(PC, name).is_differentiable is True and getattr(PC, name).full_state_update is True
