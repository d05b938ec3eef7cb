"""The port's retrieval metrics on the CPU, against the JAX package.

The 10 functionals score one query's seeded scores and targets in both
packages; the 12 classes (the 11 metrics and ``RetrievalMetric`` itself,
through a subclass) stream ragged, interleaved queries with tied scores,
queries with no positive and with no negative target under each
``empty_target_action``, ``ignore_index`` rows, each ``aggregation`` and
``top_k``. Values agree within ``ATOL``: float32 sums of at most a few dozen
terms in another order. The stable descending sort that every kernel starts
from gives the JAX package's order exactly, ties included, and so do
AUROC's average ranks and top-k positions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.retrieval as JF
import torchmetrics_tpu.retrieval as JR
import torchmetrics_tpu_torch.functional.retrieval as PF
import torchmetrics_tpu_torch.retrieval as PR

jmk = importlib.import_module("torchmetrics_tpu.functional.retrieval._masked")
pmk = importlib.import_module("torchmetrics_tpu_torch.functional.retrieval._masked")

ATOL = 1e-6
FUNCTIONAL = [
    ("retrieval_average_precision", {}),
    ("retrieval_average_precision", {"top_k": 3}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_reciprocal_rank", {"top_k": 2}),
    ("retrieval_precision", {}),
    ("retrieval_precision", {"top_k": 4}),
    ("retrieval_precision", {"top_k": 40, "adaptive_k": True}),
    ("retrieval_recall", {"top_k": 5}),
    ("retrieval_fall_out", {"top_k": 5}),
    ("retrieval_hit_rate", {"top_k": 2}),
    ("retrieval_r_precision", {}),
    ("retrieval_auroc", {}),
    ("retrieval_auroc", {"top_k": 7}),
    ("retrieval_auroc", {"max_fpr": 0.3}),
    ("retrieval_auroc", {"max_fpr": 0.5, "top_k": 9}),
    ("retrieval_auroc", {"max_fpr": 1.0}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"top_k": 4}),
    ("retrieval_precision_recall_curve", {}),
    ("retrieval_precision_recall_curve", {"max_k": 5, "adaptive_k": True}),
]


def query(seed, n=20, graded=False, tie_step=0.1):
    """One query: scores rounded to ``tie_step`` (many ties), binary or graded (0-3) targets."""
    rng = np.random.default_rng(seed)
    preds = np.round(rng.random(n) / tie_step) * tie_step
    target = rng.integers(0, 4, n) if graded else (rng.random(n) < 0.35).astype(np.int64)
    return preds.astype(np.float32), target


def assert_close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w)
        return
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want.astype(got.dtype) if want.dtype.kind in "iu" else want, atol=ATOL, rtol=0)


@pytest.mark.parametrize(("name", "kwargs"), FUNCTIONAL, ids=[f"{n}-{k}" for n, k in FUNCTIONAL])
@pytest.mark.parametrize("seed", [0, 1])
def test_functional_matches_jax(name, kwargs, seed):
    p, t = query(seed, graded="dcg" in name)
    got = getattr(PF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
    want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    assert_close(got, want)


def test_all_10_functionals_are_covered():
    assert sorted({n for n, _ in FUNCTIONAL}) == sorted(PF.__all__) and len(PF.__all__) == 10


@pytest.mark.parametrize("name", ["retrieval_normalized_dcg", "retrieval_auroc"])
@pytest.mark.parametrize("tie_step", [0.5, 0.25, 1.0])
def test_tied_scores(name, tie_step):
    """Heavy ties, down to one score for every document: nDCG's tie runs and AUROC's average ranks."""
    for seed in range(4):
        p, t = query(10 + seed, n=17, graded=name.endswith("dcg"), tie_step=tie_step)
        for kwargs in ({}, {"top_k": 5}):
            got = getattr(PF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
            want = getattr(JF, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
            assert_close(got, want)
    got = PF.retrieval_auroc(torch.from_numpy(p), torch.from_numpy(t), max_fpr=0.4)
    assert_close(got, JF.retrieval_auroc(jnp.asarray(p), jnp.asarray(t), max_fpr=0.4))


def _padded(seed, num_q=6, length=11):
    rng = np.random.default_rng(seed)
    preds = (np.round(rng.random((num_q, length)) * 4) / 4).astype(np.float32)
    target = rng.integers(0, 3, (num_q, length))
    mask = np.arange(length)[None, :] < rng.integers(1, length + 1, num_q)[:, None]
    return preds, target, mask


def test_sort_orders_and_ranks_equal_jax_exactly():
    """The stable descending sort (ties in input order, padding last), the top-k positions and AUROC's ranks."""
    preds, target, mask = _padded(1)
    _, t_sorted, m_sorted = pmk._sorted_by_preds(*(torch.from_numpy(a) for a in (preds, target, mask)))
    want_t, want_m = jax.vmap(jmk._sorted_by_preds)(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(mask))
    np.testing.assert_array_equal(t_sorted.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(m_sorted.numpy(), np.asarray(want_m))
    ranks = pmk._descending_rank(torch.from_numpy(preds), torch.from_numpy(mask))
    p_key = np.where(mask, preds, -np.inf)
    want_rank = np.argsort(np.argsort(-p_key, axis=1, kind="stable"), axis=1, kind="stable")
    np.testing.assert_array_equal(ranks.numpy(), want_rank)
    # the average ranks of the valid entries, through the run bounds of one ascending sort
    keys, order = torch.sort(torch.where(torch.from_numpy(mask), torch.from_numpy(preds), float("nan")), stable=True)
    starts, counts = pmk._run_bounds(keys)
    got = np.full(preds.shape, np.nan, np.float32)
    np.put_along_axis(got, order.numpy(), (starts.float() + (counts.float() + 1) / 2).numpy(), axis=1)
    for q in range(len(preds)):
        v = preds[q][mask[q]]
        want = (v[None, :] < v[:, None]).sum(1) + ((v[None, :] == v[:, None]).sum(1) + 1) / 2
        np.testing.assert_array_equal(got[q][mask[q]], want.astype(np.float32))


@pytest.mark.parametrize("kernel", ["average_precision_masked", "reciprocal_rank_masked", "recall_masked",
                                    "fall_out_masked", "hit_rate_masked", "ndcg_masked", "auroc_masked"])
@pytest.mark.parametrize("top_k", [None, 1, 4])
def test_batched_kernels_equal_vmapped_jax(kernel, top_k):
    preds, target, mask = _padded(2)
    got = getattr(pmk, kernel)(*(torch.from_numpy(a) for a in (preds, target, mask)), top_k=top_k)
    want = jax.vmap(lambda p, t, m: getattr(jmk, kernel)(p, t, m, top_k=top_k))(
        jnp.asarray(preds), jnp.asarray(target), jnp.asarray(mask))
    assert_close(got, want)


# ------------------------------------------------------------------ classes
def stream(seed, num_q=9, ignore=False, graded=False):
    """Three updates of ragged, interleaved queries; query 0 has no positive, query 1 no negative."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 12, num_q)
    lengths[:2] = np.maximum(lengths[:2], 3)
    indexes = np.repeat(np.arange(num_q) * 7 + 3, lengths)  # sparse, unordered query ids
    rng.shuffle(indexes)
    n = len(indexes)
    preds = (np.round(rng.random(n) * 5) / 5).astype(np.float32)
    target = rng.integers(0, 4, n) if graded else (rng.random(n) < 0.4).astype(np.int64)
    target[indexes == 3] = 0
    target[indexes == 10] = 1
    if ignore:
        target[rng.random(n) < 0.15] = -1
    cuts = sorted(rng.choice(np.arange(1, n), 2, replace=False))
    return [tuple(a[lo:hi] for a in (preds, target, indexes)) for lo, hi in zip([0, *cuts], [*cuts, n])]


CLASSES = [
    ("RetrievalMAP", {}),
    ("RetrievalMAP", {"top_k": 2, "aggregation": "median"}),
    ("RetrievalMRR", {"top_k": 3}),
    ("RetrievalRecall", {"top_k": 4, "aggregation": "min"}),
    ("RetrievalFallOut", {"top_k": 2}),
    ("RetrievalFallOut", {"empty_target_action": "neg", "aggregation": "max"}),
    ("RetrievalHitRate", {"top_k": 1}),
    ("RetrievalNormalizedDCG", {"top_k": 3}),
    ("RetrievalAUROC", {}),
    ("RetrievalAUROC", {"max_fpr": 0.5, "top_k": 6}),
    ("RetrievalPrecision", {"top_k": 3}),
    ("RetrievalPrecision", {"top_k": 5, "adaptive_k": True}),
    ("RetrievalRPrecision", {}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 6}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3, "max_k": 5}),
]


def _run(module, name, kwargs, batches, conv, use_forward):
    extra = {"device": "cpu"} if module is PR else {"auto_compile": False}
    m = getattr(module, name)(**kwargs, **extra)
    for i, (p, t, idx) in enumerate(batches):
        args = (conv(p), conv(t), conv(idx))
        if use_forward and i == 0:  # one batch by `forward`: each new shape costs the JAX side a compile
            m(*args)
        else:
            m.update(*args)
    return m.compute()


def _compare(name, kwargs, action, ignore, use_forward=True):
    kwargs = {"empty_target_action": action, **kwargs}
    if ignore:
        kwargs["ignore_index"] = -1
    # one stream for every case: the JAX side compiles each (queries, length) shape once
    batches = stream(5, ignore=ignore, graded=name.endswith("DCG"))
    use_forward = use_forward and name not in ("RetrievalPrecisionRecallCurve", "RetrievalRecallAtFixedPrecision")
    got = _run(PR, name, kwargs, batches, torch.from_numpy, use_forward)
    want = _run(JR, name, kwargs, batches, jnp.asarray, use_forward)
    assert_close(got, want)


@pytest.mark.parametrize(("name", "kwargs", "action", "ignore"),
                         [(n, k, ("neg", "pos", "skip")[i % 3], i % 2 == 1) for i, (n, k) in enumerate(CLASSES)],
                         ids=[f"{n}-{k}" for n, k in CLASSES])
def test_class_matches_jax(name, kwargs, action, ignore):
    _compare(name, kwargs, action, ignore)


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalFallOut"])
@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("ignore", [False, True])
def test_empty_target_actions(name, action, ignore):
    """Query 0 has no positive (MAP's empty query), query 1 no negative (FallOut's), under each action."""
    _compare(name, {"top_k": 3}, action, ignore, use_forward=False)


@pytest.mark.parametrize("aggregation", ["mean", "median", "min", "max"])
def test_each_aggregation(aggregation):
    batches = stream(5)
    got = _run(PR, "RetrievalMAP", {"aggregation": aggregation}, batches, torch.from_numpy, True)
    want = _run(JR, "RetrievalMAP", {"aggregation": aggregation}, batches, jnp.asarray, True)
    assert_close(got, want)


def test_callable_aggregation_and_the_base_class():
    """``RetrievalMetric`` itself: a subclass's per-query values over the same groups, reduced by a callable."""

    class PortSum(PR.RetrievalMetric):
        def _metric(self, preds, target, mask):
            return torch.where(mask, preds * (target > 0), 0.0).sum(-1)

    class JaxSum(JR.RetrievalMetric):
        def _metric(self, preds, target, mask):
            return jnp.where(mask, preds * (target > 0), 0.0).sum(-1)

    def top2(values, dim):
        return values.sort(dim=dim).values[-2:].sum() if isinstance(values, torch.Tensor) else jnp.sort(values)[-2:].sum()

    batches = stream(7)
    pm, jm = PortSum(aggregation=top2, device="cpu"), JaxSum(aggregation=top2, auto_compile=False)
    for p, t, idx in batches:
        pm.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(idx))
        jm.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(idx))
    assert_close(pm.compute(), jm.compute())
    padded = pm._group_and_pad()
    assert padded[0].shape == (9, max(int((np.concatenate([b[2] for b in batches]) == q).sum())
                                      for q in np.arange(9) * 7 + 3))


def test_all_12_classes_are_covered():
    assert sorted({n for n, _ in CLASSES} | {"RetrievalMetric"}) == sorted(PR.__all__) and len(PR.__all__) == 12


def test_empty_target_error_raises_in_both():
    batches = stream(3)
    for module, conv in ((PR, torch.from_numpy), (JR, jnp.asarray)):
        with pytest.raises(ValueError, match="without positive target"):
            _run(module, "RetrievalMAP", {"empty_target_action": "error"}, batches, conv, False)


def test_all_rows_ignored_gives_zero():
    m = PR.RetrievalMRR(ignore_index=-1, device="cpu")
    m.update(torch.tensor([0.2, 0.4]), torch.tensor([-1, -1]), torch.tensor([0, 1]))
    assert float(m.compute()) == 0.0


@pytest.mark.parametrize(("name", "kwargs", "error"), [
    ("RetrievalMAP", {"empty_target_action": "drop"}, "empty_target_action"),
    ("RetrievalMAP", {"ignore_index": 0.5}, "ignore_index"),
    ("RetrievalMAP", {"aggregation": "sum"}, "aggregation"),
    ("RetrievalMAP", {"top_k": 0}, "top_k"),
    ("RetrievalPrecision", {"adaptive_k": 1}, "adaptive_k"),
    ("RetrievalAUROC", {"max_fpr": 1.5}, "max_fpr"),
    ("RetrievalPrecisionRecallCurve", {"max_k": 0}, "max_k"),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 2.0}, "min_precision"),
])
def test_argument_errors(name, kwargs, error):
    with pytest.raises(ValueError, match=error):
        getattr(PR, name)(**kwargs, device="cpu")
    with pytest.raises(ValueError, match=error):
        getattr(JR, name)(**kwargs, auto_compile=False)


def test_update_checks():
    m = PR.RetrievalMAP(device="cpu")
    with pytest.raises(ValueError, match="cannot be None"):
        m.update(torch.zeros(3), torch.zeros(3), None)
    with pytest.raises(ValueError, match="same shape"):
        m.update(torch.zeros(3), torch.zeros(3), torch.zeros(2))
