"""The port's wrappers on the CPU, against the JAX package.

The JAX package's own cases (``tests/unittests/bases/test_wrappers.py``)
run through both packages, then each wrapper's options: labels and
prefixes, NaN rows and output axes, task collections and ``clone``,
``maximize`` lists and non-scalar steps.

``BootStrapper`` has two routes. Its loop route draws its resampling
indices from numpy's ``default_rng(seed)`` in the JAX package's order, so
with a seed it equals the JAX package's ``mean``/``std``/``quantile``/``raw``
within ``BOOT_ATOL``. The stacked route draws its counts from a
``torch.Generator``, not ``jax.random``: it is held to the loop route on one
injected count matrix within ``BOOT_ATOL``, and its draws by their mean.
``FeatureShare`` runs a counting stand-in trunk once a batch for all members,
with the values of the metrics alone and of the JAX package's ``FeatureShare``
on the same linear map.
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torchmetrics_tpu as JT
import torchmetrics_tpu.wrappers as JW
import torchmetrics_tpu_torch as PT
import torchmetrics_tpu_torch.wrappers as PW
from torchmetrics_tpu_torch.metric import Metric

boot = importlib.import_module("torchmetrics_tpu_torch.wrappers.bootstrapping")
fshare = importlib.import_module("torchmetrics_tpu_torch.wrappers.feature_share")

ATOL = 1e-6
BOOT_ATOL = 1e-6


def t(x):
    return torch.as_tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, atol=ATOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            close(got[key], want[key], atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=atol)


# ----------------------------------------------------------------- ClasswiseWrapper
@pytest.mark.parametrize(("labels", "prefix", "postfix"), [(None, None, None), (["a", "b", "c"], None, None),
                                                           (None, "cls-", None), (None, None, "_score"),
                                                           (["x", "y", "z"], "p_", "_q")])
def test_classwise_matches_jax(labels, prefix, postfix):
    rng = np.random.default_rng(0)
    preds, target = rng.integers(0, 3, (3, 20)), rng.integers(0, 3, (3, 20))
    ours = PW.ClasswiseWrapper(PT.MulticlassRecall(num_classes=3, average=None, device="cpu"), labels, prefix, postfix)
    theirs = JW.ClasswiseWrapper(JT.MulticlassRecall(num_classes=3, average=None), labels, prefix, postfix)
    close(ours(t(preds[0]), t(target[0])), theirs(j(preds[0]), j(target[0])))
    for b in (1, 2):
        ours.update(t(preds[b]), t(target[b]))
        theirs.update(j(preds[b]), j(target[b]))
    close(ours.compute(), theirs.compute())
    with pytest.raises(ValueError, match="Expected argument `labels`"):
        PW.ClasswiseWrapper(PT.MulticlassRecall(num_classes=3, average=None, device="cpu"), labels=["a", 1])
    with pytest.raises(ValueError, match="Expected argument `metric`"):
        PW.ClasswiseWrapper(lambda x: x)


# --------------------------------------------------------------------- MinMaxMetric
def test_minmax_forward_reference_vector():
    """The reference's own forward test (tests/unittests/wrappers/test_minmax.py::test_basic_example)."""
    preds = ([[0.9, 0.1], [0.2, 0.8]], [[0.1, 0.9], [0.2, 0.8]], [[0.1, 0.9], [0.8, 0.2]])
    labels = [[0, 1], [0, 1]]
    ours, theirs = PW.MinMaxMetric(PT.BinaryAccuracy(device="cpu")), JW.MinMaxMetric(JT.BinaryAccuracy())
    for p in preds:
        close(ours(t(p), t(labels)), theirs(j(p), j(labels)))
        close(ours.compute(), theirs.compute())
    ours.reset()  # min and max survive reset
    assert float(ours.max_val) == 1.0 and float(ours.min_val) == 0.5


def test_minmax_updates_and_errors():
    ours, theirs = PW.MinMaxMetric(PT.BinaryAccuracy(device="cpu")), JW.MinMaxMetric(JT.BinaryAccuracy())
    for p in ([1.0, 1.0], [0.0, 0.0], [1.0, 0.0]):
        ours.update(t(p), t([1, 1]))
        theirs.update(j(p), j([1, 1]))
        close(ours.compute(), theirs.compute())
    vector = PW.MinMaxMetric(PT.MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
    vector.update(t([0, 1, 2]), t([0, 1, 1]))
    with pytest.raises(RuntimeError, match="should be a float or scalar"):
        vector.compute()
    with pytest.raises(ValueError, match="Expected base metric"):
        PW.MinMaxMetric(1.0)


# --------------------------------------------------------------- MultioutputWrapper
@pytest.mark.parametrize(("name", "output_dim", "remove_nans", "squeeze"),
                         [("MeanSquaredError", -1, True, True), ("R2Score", -1, True, True),
                          ("R2Score", 0, False, True), ("MeanAbsoluteError", -1, False, True),
                          ("PearsonCorrCoef", -1, True, True)])
def test_multioutput_matches_jax(name, output_dim, remove_nans, squeeze):
    rng = np.random.default_rng(1)
    shape = (3, 40) if output_dim == 0 else (40, 3)
    preds = rng.normal(size=(2,) + shape).astype(np.float32)
    target = (preds + 0.3 * rng.normal(size=preds.shape)).astype(np.float32)
    if remove_nans:
        row_out = (lambda row, out: (row, out)) if output_dim == -1 else (lambda row, out: (out, row))
        preds[(0, *row_out(3, 1))] = np.nan
        target[(1, *row_out(7, 2))] = np.nan
    kwargs = {"output_dim": output_dim, "remove_nans": remove_nans, "squeeze_outputs": squeeze}
    ours = PW.MultioutputWrapper(getattr(PT, name)(device="cpu"), num_outputs=3, **kwargs)
    theirs = JW.MultioutputWrapper(getattr(JT, name)(), num_outputs=3, **kwargs)
    close(ours(t(preds[0]), t(target[0])), theirs(j(preds[0]), j(target[0])))
    ours.update(t(preds[1]), t(target[1]))
    theirs.update(j(preds[1]), j(target[1]))
    got = ours.compute()
    assert got.shape == (3,)
    close(got, theirs.compute())
    assert isinstance(ours.metrics, nn.ModuleList) and len(ours.metrics) == 3


def test_multioutput_nan_rows_are_dropped_per_output():
    """With remove_nans, output 1's NaN row leaves outputs 0 and 2 untouched: each equals its metric alone."""
    preds = torch.tensor([[1.0, 2.0, 3.0], [2.0, float("nan"), 1.0], [4.0, 4.0, 0.0], [0.0, 1.0, 2.0]])
    target = torch.tensor([[1.5, 2.0, 2.0], [2.0, 3.0, 1.0], [3.0, 5.0, 1.0], [1.0, 1.0, 2.0]])
    wrapped = PW.MultioutputWrapper(PT.MeanSquaredError(device="cpu"), num_outputs=3)
    wrapped.update(preds, target)
    for i in range(3):
        keep = ~torch.isnan(preds[:, i])
        alone = PT.MeanSquaredError(device="cpu")
        alone.update(preds[keep, i], target[keep, i])
        assert float(wrapped.compute()[i]) == float(alone.compute())


# ---------------------------------------------------------------- MultitaskWrapper
def test_multitask_matches_jax():
    rng = np.random.default_rng(2)
    cls_p, cls_t = rng.random((2, 30)).astype(np.float32), rng.integers(0, 2, (2, 30))
    reg_p, reg_t = rng.normal(size=(2, 30)).astype(np.float32), rng.normal(size=(2, 30)).astype(np.float32)
    ours = PW.MultitaskWrapper({
        "cls": PT.MetricCollection([PT.BinaryAccuracy(device="cpu"), PT.BinaryF1Score(device="cpu")]),
        "reg": PT.MeanSquaredError(device="cpu"),
    }, prefix="val_")
    theirs = JW.MultitaskWrapper({
        "cls": JT.MetricCollection([JT.BinaryAccuracy(), JT.BinaryF1Score()]),
        "reg": JT.MeanSquaredError(),
    }, prefix="val_")
    close(ours({"cls": t(cls_p[0]), "reg": t(reg_p[0])}, {"cls": t(cls_t[0]), "reg": t(reg_t[0])}),
          theirs({"cls": j(cls_p[0]), "reg": j(reg_p[0])}, {"cls": j(cls_t[0]), "reg": j(reg_t[0])}))
    ours.update({"cls": t(cls_p[1]), "reg": t(reg_p[1])}, {"cls": t(cls_t[1]), "reg": t(reg_t[1])})
    theirs.update({"cls": j(cls_p[1]), "reg": j(reg_p[1])}, {"cls": j(cls_t[1]), "reg": j(reg_t[1])})
    close(ours.compute(), theirs.compute())
    assert list(ours.keys()) == list(theirs.keys()) == ["cls_BinaryAccuracy", "cls_BinaryF1Score", "reg"]
    assert list(ours.keys(flatten=False)) == ["cls", "reg"]
    assert [name for name, _ in ours.items()] == [name for name, _ in theirs.items()]
    assert len(list(ours.values())) == 3 and len(list(ours.values(flatten=False))) == 2
    clone = ours.clone(prefix="test_", postfix="_x")
    assert sorted(clone.compute()) == ["test_cls_x", "test_reg_x"] and clone is not ours
    close(clone.compute()["test_reg_x"], ours.compute()["val_reg"])
    with pytest.raises(ValueError, match="same keys"):
        ours.update({"cls": t(cls_p[0])}, {"cls": t(cls_t[0])})
    with pytest.raises(TypeError, match="to be a dict"):
        PW.MultitaskWrapper([PT.MeanSquaredError(device="cpu")])
    with pytest.raises(TypeError, match="Metric or a MetricCollection"):
        PW.MultitaskWrapper({"a": 1})


# ------------------------------------------------------------------- MetricTracker
def test_tracker_matches_jax():
    ours, theirs = PW.MetricTracker(PT.BinaryAccuracy(device="cpu")), JW.MetricTracker(JT.BinaryAccuracy())
    with pytest.raises(ValueError, match="cannot be called before"):
        ours.update(t([1]), t([1]))
    for batch in ([1, 1], [1, 0], [0, 0], [1, 1]):
        ours.increment()
        theirs.increment()
        close(ours(t(batch), t([1, 1])), theirs(j(batch), j([1, 1])))
    close(ours.compute_all(), theirs.compute_all())
    best, step = ours.best_metric(return_step=True)
    want_best, want_step = theirs.best_metric(return_step=True)
    assert float(best) == float(want_best) == 1.0 and step == want_step == 0
    assert ours.n_steps == 4
    ours.reset_all()
    assert ours.n_steps == 0


@pytest.mark.parametrize("maximize", [[True, False], [False, True], True, None])
def test_tracker_with_a_collection_and_maximize_list(maximize):
    rng = np.random.default_rng(3)
    members = lambda pkg, **kw: [pkg.MeanSquaredError(**kw), pkg.PearsonCorrCoef(**kw)]  # noqa: E731
    ours = PW.MetricTracker(PT.MetricCollection(members(PT, device="cpu")), maximize=maximize)
    theirs = JW.MetricTracker(JT.MetricCollection(members(JT)), maximize=maximize)
    for _ in range(4):
        p = rng.normal(size=20).astype(np.float32)
        y = (p + rng.normal(size=20)).astype(np.float32)
        ours.increment()
        theirs.increment()
        ours.update(t(p), t(y))
        theirs.update(j(p), j(y))
    close(ours.compute_all(), theirs.compute_all())
    (best, steps), (want_best, want_steps) = ours.best_metric(return_step=True), theirs.best_metric(return_step=True)
    assert steps == want_steps
    close(best, want_best)


def test_tracker_best_metric_of_non_scalar_steps_warns_and_returns_none():
    tracker = PW.MetricTracker(PT.MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
    for _ in range(2):
        tracker.increment()
        tracker.update(t([0, 1, 2]), t([0, 1, 1]))
    with pytest.warns(UserWarning, match="Returning `None` instead"):
        assert tracker.best_metric() is None
    with pytest.warns(UserWarning, match="Returning `None` instead"):
        assert tracker.best_metric(return_step=True) == (None, None)
    with pytest.raises(TypeError, match="Metric arg need to be"):
        PW.MetricTracker(1)
    with pytest.raises(ValueError, match="single bool or list of bool"):
        PW.MetricTracker(PT.BinaryAccuracy(device="cpu"), maximize=[1, 0])
    with pytest.raises(AttributeError, match="higher_is_better"):
        PW.MetricTracker(PT.MulticlassStatScores(num_classes=3, device="cpu"), maximize=None)


# --------------------------------------------------------------------- BootStrapper
def boot_data(seed=4, batches=4, size=48, c=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batches, size, c)).astype(np.float32), rng.integers(0, c, (batches, size))


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize(("quantile", "raw"), [(None, False), (0.25, True), (np.array([0.1, 0.9]), False)])
def test_bootstrapper_loop_route_equals_jax_with_a_seed(strategy, quantile, raw):
    logits, target = boot_data()
    kwargs = {"num_bootstraps": 6, "sampling_strategy": strategy, "seed": 11, "quantile": quantile, "raw": raw}
    ours = PW.BootStrapper(PT.MulticlassAccuracy(num_classes=5, device="cpu"), **kwargs)
    theirs = JW.BootStrapper(JT.MulticlassAccuracy(num_classes=5), **kwargs)
    for b in range(len(logits)):
        ours.update(t(logits[b]), t(target[b]))
        theirs.update(j(logits[b]), j(target[b]))
    assert ours.route_counts == {"loop": len(logits), "stacked": 0}  # validate_args=True: the loop throughout
    close(ours.compute(), theirs.compute(), atol=BOOT_ATOL)


def test_bootstrapper_of_an_integer_metric_equals_jax():
    """A confusion matrix's int counts: mean, std and quantile in float32 as the JAX package promotes them, raw as ints."""
    logits, target = boot_data(seed=13, batches=3)
    kwargs = {"num_bootstraps": 5, "seed": 2, "quantile": 0.5, "raw": True}
    ours = PW.BootStrapper(PT.MulticlassConfusionMatrix(num_classes=5, device="cpu"), **kwargs)
    theirs = JW.BootStrapper(JT.MulticlassConfusionMatrix(num_classes=5), **kwargs)
    for b in range(len(logits)):
        ours.update(t(logits[b]), t(target[b]))
        theirs.update(j(logits[b]), j(target[b]))
    got, want = ours.compute(), theirs.compute()
    assert got["mean"].dtype == torch.float32 and not got["raw"].is_floating_point()
    close(got, want, atol=BOOT_ATOL)


def test_bootstrapper_without_a_seed_draws_the_stacked_seed_first(monkeypatch):
    """seed=None: both packages draw the stacked route's seed from the wrapper's rng before any index."""
    real_default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: real_default_rng(123))
    logits, target = boot_data(seed=12, batches=2)
    ours = PW.BootStrapper(PT.MulticlassAccuracy(num_classes=5, device="cpu"), num_bootstraps=4, raw=True)
    theirs = JW.BootStrapper(JT.MulticlassAccuracy(num_classes=5), num_bootstraps=4, raw=True)
    replay = real_default_rng(123)
    assert ours._generator.initial_seed() == int(replay.integers(2**31))
    for b in range(2):
        ours.update(t(logits[b]), t(target[b]))
        theirs.update(j(logits[b]), j(target[b]))
    close(ours.compute(), theirs.compute(), atol=BOOT_ATOL)


class CountsFromMatrix:
    """Replaces the loop's per-copy sampler and the stacked route's draw with one count matrix per batch."""

    def __init__(self, counts):
        self.counts, self.batch, self.copy = counts, 0, 0

    def sampler(self, size, strategy, rng):
        row = self.counts[self.batch][self.copy]
        self.copy += 1
        if self.copy == len(self.counts[self.batch]):
            self.batch, self.copy = self.batch + 1, 0
        return np.repeat(np.arange(size), row)

    def draw(self, size):
        out = torch.as_tensor(self.counts[self.batch], dtype=torch.float32)
        self.batch += 1
        return out


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("base", ["accuracy", "mse"])
def test_stacked_route_equals_the_loop_on_one_count_matrix(strategy, base, monkeypatch):
    logits, target = boot_data(seed=5, batches=5)
    rng = np.random.default_rng(6)
    n_boot, size = 8, logits.shape[1]
    if strategy == "poisson":
        counts = rng.poisson(1, (len(logits), n_boot, size))
    else:
        counts = np.stack([np.stack([np.bincount(rng.integers(0, size, size), minlength=size) for _ in range(n_boot)])
                           for _ in range(len(logits))])

    def make(validate):
        if base == "accuracy":
            return PT.MulticlassAccuracy(num_classes=5, validate_args=validate, device="cpu")
        return PT.MeanSquaredError(device="cpu")

    def inputs(b):
        if base == "accuracy":
            return t(logits[b]), t(target[b])
        return t(logits[b][:, 0]), t(logits[b][:, 1])

    stacked_src = CountsFromMatrix(counts)
    stacked = PW.BootStrapper(make(False), num_bootstraps=n_boot, sampling_strategy=strategy, raw=True, seed=0)
    monkeypatch.setattr(boot, "_bootstrap_sampler", stacked_src.sampler)  # the first batch runs the loop
    monkeypatch.setattr(stacked, "_draw_counts", stacked_src.draw)
    for b in range(len(logits)):
        stacked.update(*inputs(b))
    assert stacked.route_counts == {"loop": 1, "stacked": len(logits) - 1}
    got = stacked.compute()
    if base == "accuracy":  # validate_args=True keeps the same metric on the loop throughout
        loop = PW.BootStrapper(make(True), num_bootstraps=n_boot, sampling_strategy=strategy, raw=True, seed=0)
        monkeypatch.setattr(boot, "_bootstrap_sampler", CountsFromMatrix(counts).sampler)
        for b in range(len(logits)):
            loop.update(*inputs(b))
        assert loop.route_counts == {"loop": len(logits), "stacked": 0}
        close(got, loop.compute(), atol=BOOT_ATOL)
        return
    # MeanSquaredError has no validate_args to keep it on the loop: each copy's own metric on its rows instead
    want = []
    for i in range(n_boot):
        alone = PT.MeanSquaredError(device="cpu")
        for b in range(len(logits)):
            p, y = inputs(b)
            idx = torch.from_numpy(np.repeat(np.arange(size), counts[b][i]))
            alone.update(p[idx], y[idx])
        want.append(float(alone.compute()))
    close(got["raw"], np.array(want, np.float32), atol=BOOT_ATOL)


class BatchMax(Metric):
    """Sum-reduced state, but not additive over samples: a batch's max is not the sum of its samples'."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.total += x.max()

    def compute(self):
        return self.total


class CatMean(Metric):
    """A ``cat`` list state: not a stack of fixed shape."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("values", [], dist_reduce_fx="cat")

    def update(self, x):
        self.values.append(x)

    def compute(self):
        return torch.cat(self.values).mean()


class HostReadSum(Metric):
    """An additive update that cannot run under vmap: it reads a value on the host (``.item()``)."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.total += x.sum().item()

    def compute(self):
        return self.total


class BincountPairs(Metric):
    """A pair histogram counted with an integer ``bincount``, which has no batching rule."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("counts", torch.zeros(9, dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds, target):
        self.counts += torch.bincount(target * 3 + preds, minlength=9)

    def compute(self):
        return self.counts


@pytest.mark.parametrize(("make", "reason"), [
    (lambda: BatchMax(device="cpu"), "additivity"),
    (lambda: HostReadSum(device="cpu"), "vmap"),
    (lambda: CatMean(device="cpu"), "cat state"),
    (lambda: PT.MaxMetric(device="cpu"), "max state"),
    (lambda: PT.MulticlassAccuracy(num_classes=3, device="cpu"), "validate_args"),
    # an integer bincount has no batching rule: its per-sample vmap fallback is an error on this route
    (lambda: BincountPairs(device="cpu"), "bincount"),
])
def test_stacked_route_switches_to_the_loop(make, reason):
    metric = PW.BootStrapper(make(), num_bootstraps=3, seed=1)
    x = torch.tensor([0, 3, 1, 2, 1, 1])
    for _ in range(3):
        if reason in ("validate_args", "bincount"):
            metric.update(x % 3, torch.tensor([0, 2, 1, 2, 1, 0]))
        else:
            metric.update(x.float())
    assert metric.route_counts == {"loop": 3, "stacked": 0}, reason
    assert metric._fast_disabled
    assert torch._C._functorch._is_vmap_fallback_enabled()  # the wrapper restores the global switch
    metric.compute()


def test_a_confusion_matrix_takes_the_stacked_route():
    """Kernel B1's plain version counts with an out-of-place ``index_add`` under vmap (a stream pool's lanes),
    so a confusion matrix's per-sample deltas vmap and BootStrapper stacks its copies."""
    metric = PW.BootStrapper(PT.MulticlassConfusionMatrix(num_classes=3, validate_args=False, device="cpu"),
                             num_bootstraps=4, seed=1, raw=True)
    x = torch.tensor([0, 3, 1, 2, 1, 1])
    for _ in range(3):
        metric.update(x % 3, torch.tensor([0, 2, 1, 2, 1, 0]))
    assert metric.route_counts == {"loop": 1, "stacked": 2} and not metric._fast_disabled
    raw = metric.compute()["raw"]
    assert raw.shape == (4, 3, 3) and bool((raw >= 0).all()) and torch.equal(raw, raw.round())


def test_a_batch_whose_per_sample_deltas_pass_the_bound_takes_the_loop(monkeypatch):
    """The stacked route holds a batch's per-sample deltas; a batch that would hold more than the bound takes the
    loop, that batch only (a 1000-class confusion matrix at a batch of 1024 would hold 8 GB)."""
    boot = importlib.import_module("torchmetrics_tpu_torch.wrappers.bootstrapping")
    metric = PW.BootStrapper(PT.MulticlassConfusionMatrix(num_classes=3, validate_args=False, device="cpu"),
                             num_bootstraps=4, seed=1, raw=True)
    # 9 int32 cells a sample, each also in float32: 72 bytes a sample
    assert metric._delta_bytes(["confmat"], 6) == 6 * 9 * (4 + 4)
    monkeypatch.setattr(boot, "_STACKED_DELTA_BYTES", 5 * 72)
    x, y = torch.tensor([0, 2, 1, 2, 1, 1]), torch.tensor([0, 2, 1, 2, 1, 0])
    for size in (6, 6, 5, 6, 5):
        metric.update(x[:size], y[:size])
    assert metric.route_counts == {"loop": 3, "stacked": 2} and not metric._fast_disabled
    raw = metric.compute()["raw"]
    assert raw.shape == (4, 3, 3) and bool((raw >= 0).all()) and torch.equal(raw, raw.round())


def test_stacked_route_counts_have_their_law_and_resume_after_pickling():
    metric = PW.BootStrapper(PT.MeanSquaredError(device="cpu"), num_bootstraps=200, seed=7)
    poisson = metric._draw_counts(500)
    assert poisson.shape == (200, 500) and poisson.dtype == torch.float32
    assert abs(float(poisson.mean()) - 1.0) < 0.01 and abs(float(poisson.var()) - 1.0) < 0.03
    multinomial = PW.BootStrapper(PT.MeanSquaredError(device="cpu"), num_bootstraps=50, seed=7,
                                  sampling_strategy="multinomial")
    counts = multinomial._draw_counts(64)
    assert torch.equal(counts.sum(dim=1), torch.full((50,), 64.0)) and abs(float(counts.mean()) - 1.0) < 1e-6

    # a pickled seeded run resumes the stream it would have drawn, in the middle of a stacked stream
    rng = np.random.default_rng(8)
    data = [t(rng.normal(size=(16, 2)).astype(np.float32)) for _ in range(4)]
    a = PW.BootStrapper(PT.MeanSquaredError(device="cpu"), num_bootstraps=5, seed=3, raw=True)
    for x in data[:2]:
        a.update(x[:, 0], x[:, 1])
    b = pickle.loads(pickle.dumps(a))
    for x in data[2:]:
        a.update(x[:, 0], x[:, 1])
        b.update(x[:, 0], x[:, 1])
    assert a.route_counts["stacked"] == 3
    np.testing.assert_array_equal(a.compute()["raw"].numpy(), b.compute()["raw"].numpy())


def test_stacked_route_is_exact_for_the_copies_own_updates():
    """Materialised copies carry the stacked updates' counts; a reset re-warms with the loop."""
    logits, target = boot_data(seed=9, batches=3)
    metric = PW.BootStrapper(PT.MulticlassAccuracy(num_classes=5, validate_args=False, device="cpu"),
                             num_bootstraps=4, seed=2)
    for b in range(3):
        metric.update(t(logits[b]), t(target[b]))
    out = metric.compute()
    assert all(m.update_count == 3 for m in metric.metrics) and set(out) == {"mean", "std"}
    metric.reset()
    metric.update(t(logits[0]), t(target[0]))
    assert metric.route_counts == {"loop": 1, "stacked": 0}
    with pytest.raises(ValueError, match="Expected argument ``sampling_strategy``"):
        PW.BootStrapper(PT.MeanSquaredError(device="cpu"), sampling_strategy="jackknife")
    with pytest.raises(ValueError, match="Expected base metric"):
        PW.BootStrapper(1)
    with pytest.raises(ValueError, match="None of the input contained any tensor"):
        PW.BootStrapper(PT.SumMetric(device="cpu"), num_bootstraps=2).update(1.0)


# --------------------------------------------------------------------- FeatureShare
class CountingTrunk(nn.Module):
    """A stand-in feature extractor: a fixed linear map of the flattened images, counting its calls."""

    num_features = 8

    def __init__(self, seed):
        super().__init__()
        self.proj = nn.Parameter(torch.randn(3 * 4 * 4, 8, generator=torch.Generator().manual_seed(seed)))
        self.calls = 0

    def forward(self, imgs):
        self.calls += 1
        return imgs.reshape(len(imgs), -1).to(torch.float32) @ self.proj


class JaxTrunk:
    """The same linear map in the JAX package's terms: a plain callable, as its ``feature=`` takes."""

    num_features = 8

    def __init__(self, torch_trunk):
        self.proj = jnp.asarray(torch_trunk.proj.detach().numpy())
        self.calls = 0

    def __call__(self, imgs):
        self.calls += 1
        return jnp.asarray(imgs, jnp.float32).reshape(imgs.shape[0], -1) @ self.proj


def shared_members(trunk):
    return [PT.FrechetInceptionDistance(feature=trunk, device="cpu"),
            PT.KernelInceptionDistance(feature=trunk, subsets=3, subset_size=10, device="cpu"),
            PT.MemorizationInformedFrechetInceptionDistance(feature=trunk, device="cpu")]


def jax_shared_members(trunk):
    import torchmetrics_tpu.image as JI

    return [JI.FrechetInceptionDistance(feature=trunk, auto_compile=False),
            JI.KernelInceptionDistance(feature=trunk, subsets=3, subset_size=10, auto_compile=False),
            JI.MemorizationInformedFrechetInceptionDistance(feature=trunk, auto_compile=False)]


def member_values(members, seed=0):
    out = []
    for m in members:
        np.random.seed(seed)  # KID draws its subsets from numpy's global generator, in both packages
        value = m.compute()
        out.extend(value if isinstance(value, tuple) else (value,))
    return out


def test_feature_share_runs_the_trunk_once_a_batch():
    rng = np.random.default_rng(10)
    real = [t(rng.integers(0, 256, (12, 3, 4, 4)).astype(np.uint8)) for _ in range(3)]
    fake = [t(rng.integers(0, 256, (12, 3, 4, 4)).astype(np.uint8)) for _ in range(3)]
    first, other = CountingTrunk(0), CountingTrunk(0)
    members = shared_members(first)
    members[1].inception = members[2].inception = other  # each member brought its own trunk
    shared = PW.FeatureShare(members)
    assert isinstance(members[0].inception, fshare.NetworkCache)
    assert all(m.inception is members[0].inception for m in members) and members[0].inception.network is first
    assert members[0].inception.num_features == 8  # attributes reach the trunk through the cache
    for r, f in zip(real, fake):
        shared.update(r, real=True)
        shared.update(f, real=False)
    assert first.calls == 6 and other.calls == 0
    alone = shared_members(CountingTrunk(0))
    for r, f in zip(real, fake):
        for m in alone:
            m.update(r, real=True)
            m.update(f, real=False)
    got = member_values(members)
    for g, w in zip(got, member_values(alone)):  # same trunk, same inputs: equal bit for bit
        assert torch.equal(g, w)

    # the JAX package's FeatureShare over its FID, KID and MiFID, on the same linear map and images
    jax_trunk = JaxTrunk(first)
    jax_members = jax_shared_members(jax_trunk)
    jax_shared = JW.FeatureShare(jax_members)
    for r, f in zip(real, fake):
        jax_shared.update(j(r), real=True)
        jax_shared.update(j(f), real=False)
    assert jax_trunk.calls == 6
    close([g.detach() for g in got], member_values(jax_members))
    shared.to("cpu")  # the shared trunk is a child module: .to() reaches it once
    assert sum(1 for p in shared.parameters()) == 1


@pytest.mark.parametrize("inference", [False, True])
def test_feature_share_misses_the_cache_for_a_buffer_rewritten_in_place(inference):
    """One input buffer refilled between the real and the fake update runs the trunk for each, as the metrics alone do.

    A tensor's version counter marks the rewrite. An inference tensor has none: its features are kept only for one
    collection call, and a member called on its own runs the trunk every time.
    """
    rng = np.random.default_rng(11)
    real = [t(rng.integers(0, 256, (12, 3, 4, 4)).astype(np.uint8)) for _ in range(3)]
    fake = [t(rng.integers(0, 256, (12, 3, 4, 4)).astype(np.uint8)) for _ in range(3)]
    trunk = CountingTrunk(3)
    members = shared_members(trunk)
    shared = PW.FeatureShare(members)
    with torch.inference_mode(inference):
        buf = torch.empty((12, 3, 4, 4), dtype=torch.uint8)
        for r, f in zip(real, fake):
            buf.copy_(r)
            shared.update(buf, real=True)
            buf.copy_(f)
            shared.update(buf, real=False)
        assert trunk.calls == 6
        members[0].inception(buf)
        members[1].inception(buf)
        assert trunk.calls == 8 if inference else 7
        alone = shared_members(CountingTrunk(3))  # under the same autograd mode, whose products may round apart
        for r, f in zip(real, fake):
            for m in alone:
                m.update(r, real=True)
                m.update(f, real=False)
    for g, w in zip(member_values(members), member_values(alone)):
        assert torch.equal(g, w)
    assert not members[0].inception._cache or not inference  # nothing unversioned outlives its collection call


def test_feature_share_errors_and_cache_size():
    with pytest.raises(AttributeError, match="did not have a `feature_network` attribute"):
        PW.FeatureShare([PT.MeanSquaredError(device="cpu")])
    with pytest.raises(TypeError, match="max_cache_size should be an integer"):
        PW.FeatureShare(shared_members(CountingTrunk(1))[:1], max_cache_size=2.0)
    trunk = CountingTrunk(2)
    cache = fshare.NetworkCache(trunk, max_size=2)
    x, y, z = (torch.zeros((1, 3, 4, 4)) + v for v in range(3))
    for imgs in (x, y, x, z, x, y):
        cache(imgs)
    assert trunk.calls == 4  # x, y, then z evicts y, and y again

    class Plain:  # a member's ``feature=`` may be a plain callable: it stays an attribute, reached the same way
        num_features = 8

        def __call__(self, imgs):
            return imgs.reshape(len(imgs), -1)

    plain = fshare.NetworkCache(Plain())
    assert "network" not in plain._modules and plain.num_features == 8 and plain(x).shape == (1, 48)


def test_exports_equal_the_jax_package():
    assert sorted(PW.__all__) == sorted(JW.__all__)
    for name in PW.__all__:
        assert getattr(PT, name) is getattr(PW, name)
