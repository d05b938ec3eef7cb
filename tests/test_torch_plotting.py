"""The port's plotting surface against the JAX package's (``tests/unittests/bases/test_plotting.py``).

The first four classes are the counterparts of the JAX suite's 21 test
functions, with their parametrizations, on the port's classes and the port's
``utilities/plot.py`` (inputs drawn from a seeded numpy generator, CPU
tensors). ``test_figures_match_the_jax_package`` then draws the same numpy
values through both packages and compares what was drawn: axes count,
titles, axis labels, limits, line data, bar heights, legend texts, texts and
the dashed bound lines, at rtol 1e-5 / atol 1e-6 (float32 curves and areas
of equal inputs). A number printed in a text (a legend's ``AUC=0.418``) may
differ by one unit in its last printed digit: the two packages sum an area's
trapezoids in another order, and an area 1 ulp from a rounding boundary
(0.41749999 against 0.41750002 for one binary ROC here) prints either way.
"""

import re

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as tt
from torchmetrics_tpu_torch.classification import (
    BinaryAccuracy,
    BinaryF1Score,
    BinaryPrecisionRecallCurve,
    BinaryROC,
    MulticlassAccuracy,
    MulticlassConfusionMatrix,
    MulticlassPrecisionRecallCurve,
    MulticlassROC,
    MultilabelConfusionMatrix,
    MultilabelPrecisionRecallCurve,
    MultilabelROC,
)
from torchmetrics_tpu_torch.utilities.plot import plot_confusion_matrix, plot_curve, plot_single_or_multi_val

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _ints(seed, shape, high):
    return np.random.default_rng(seed).integers(0, high, shape)


class TestPlotSingleOrMultiVal:
    def test_scalar(self):
        fig, ax = plot_single_or_multi_val(torch.tensor(0.7))
        assert fig is not None

    def test_vector_bar(self):
        fig, ax = plot_single_or_multi_val(torch.tensor([0.1, 0.5, 0.9]))
        assert len(ax.patches) == 3

    def test_dict(self):
        fig, ax = plot_single_or_multi_val({"acc": torch.tensor(0.7), "f1": torch.tensor(0.6)})
        assert len(ax.get_legend_handles_labels()[1]) == 2

    def test_sequence_of_scalars(self):
        fig, ax = plot_single_or_multi_val([torch.tensor(0.1), torch.tensor(0.2), torch.tensor(0.3)])
        assert ax.get_xlabel() == "Step"

    def test_sequence_of_dicts(self):
        vals = [{"a": torch.tensor(0.1), "b": torch.tensor(0.2)} for _ in range(3)]
        fig, ax = plot_single_or_multi_val(vals)
        assert len(ax.get_legend_handles_labels()[1]) == 2

    def test_bounds_drawn(self):
        fig, ax = plot_single_or_multi_val(torch.tensor(0.7), lower_bound=0.0, upper_bound=1.0)
        assert len(ax.collections) >= 1  # hlines

    def test_metric_binding(self):
        m = MulticlassAccuracy(num_classes=3, device="cpu")
        vals = [m(_t(_uniform(i, (16, 3))), _t(_ints(100 + i, (16,), 3))) for i in range(4)]
        fig, ax = m.plot(vals)
        assert fig is not None


class TestPlotConfusionMatrix:
    def test_single_panel(self):
        fig, ax = plot_confusion_matrix(torch.arange(9).reshape(3, 3))
        assert len(ax.texts) == 9

    def test_labels(self):
        fig, ax = plot_confusion_matrix(np.arange(9).reshape(3, 3), labels=["a", "b", "c"])
        assert [t.get_text() for t in ax.get_xticklabels()] == ["a", "b", "c"]

    def test_wrong_label_count_raises(self):
        with pytest.raises(ValueError, match="Expected number of elements"):
            plot_confusion_matrix(np.zeros((3, 3)), labels=["a"])

    def test_multilabel_grid(self):
        fig, axs = plot_confusion_matrix(torch.arange(12).reshape(3, 2, 2))
        assert len(axs) == 3

    def test_multilabel_single_label(self):
        fig, axs = plot_confusion_matrix(np.zeros((1, 2, 2)))
        assert len(axs) == 1

    def test_multilabel_wrong_label_count_raises(self):
        with pytest.raises(ValueError, match="Expected number of elements"):
            plot_confusion_matrix(np.zeros((3, 2, 2)), labels=["a"])

    def test_metric_binding(self):
        m = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        m(_t(_uniform(0, (40, 3))), _t(_ints(0, (40,), 3)))
        fig, ax = m.plot()
        assert fig is not None

        ml = MultilabelConfusionMatrix(num_labels=4, device="cpu")
        ml(_t(_uniform(0, (40, 4))), _t(_ints(0, (40, 4), 2)))
        fig, axs = ml.plot()
        assert fig is not None


class TestPlotCurves:
    @pytest.mark.parametrize("thresholds", [None, 10])
    @pytest.mark.parametrize("score", [False, True])
    @pytest.mark.parametrize("cls", [BinaryROC, BinaryPrecisionRecallCurve])
    def test_binary(self, cls, thresholds, score):
        m = cls(thresholds=thresholds, device="cpu")
        m.update(_t(_uniform(0, (30,))), _t(_ints(0, (30,), 2)))
        fig, ax = m.plot(score=score)
        assert len(ax.lines) == 1
        if score:
            assert "AUC" in (ax.get_legend_handles_labels()[1] or [""])[0]

    @pytest.mark.parametrize("thresholds", [None, 10])
    @pytest.mark.parametrize("cls", [MulticlassROC, MulticlassPrecisionRecallCurve])
    def test_multiclass(self, cls, thresholds):
        preds = _uniform(0, (30, 4))
        preds = preds / preds.sum(-1, keepdims=True)
        m = cls(num_classes=4, thresholds=thresholds, device="cpu")
        m.update(_t(preds), _t(_ints(0, (30,), 4)))
        fig, ax = m.plot(score=True)
        assert len(ax.lines) == 4

    @pytest.mark.parametrize("thresholds", [None, 10])
    @pytest.mark.parametrize("cls", [MultilabelROC, MultilabelPrecisionRecallCurve])
    def test_multilabel(self, cls, thresholds):
        m = cls(num_labels=3, thresholds=thresholds, device="cpu")
        m.update(_t(_uniform(0, (30, 3))), _t(_ints(0, (30, 3), 2)))
        fig, ax = m.plot(score=True)
        assert len(ax.lines) == 3

    def test_plot_curve_axis_labels(self):
        m = BinaryROC(thresholds=10, device="cpu")
        m.update(_t(_uniform(0, (30,))), _t(_ints(0, (30,), 2)))
        fig, ax = m.plot()
        assert ax.get_xlabel() == "False positive rate"
        assert ax.get_ylabel() == "True positive rate"
        assert ax.get_title() == "BinaryROC"

    def test_plot_curve_precomputed(self):
        curve = (torch.linspace(0, 1, 5), torch.linspace(0, 1, 5), torch.linspace(1, 0, 5))
        fig, ax = plot_curve(curve, score=torch.tensor(0.5), label_names=("x", "y"))
        assert "AUC=0.500" in ax.get_legend_handles_labels()[1][0]


class TestTrackerPlot:
    def test_scalar_metric(self):
        tr = tt.MetricTracker(BinaryAccuracy(device="cpu"))
        for ep in ([1, 1], [1, 0], [0, 1]):
            tr.increment()
            tr.update(torch.tensor(ep, dtype=torch.float32), torch.tensor([1, 1]))
        fig, ax = tr.plot()
        assert ax.get_xlabel() == "Step"

    def test_collection(self):
        tr = tt.MetricTracker(
            tt.MetricCollection({"a": BinaryAccuracy(device="cpu"), "f": BinaryF1Score(device="cpu")})
        )
        for ep in ([1, 1], [1, 0]):
            tr.increment()
            tr.update(torch.tensor(ep, dtype=torch.float32), torch.tensor([1, 1]))
        fig, ax = tr.plot()
        assert len(ax.get_legend_handles_labels()[1]) == 2


# ------------------------------------------------------------------ parity with the JAX package
def _describe(axes):
    """What was drawn on each axis, as plain values."""
    out = []
    for ax in np.atleast_1d(np.asarray(axes, dtype=object)).ravel():
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(),
            "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "xlim": np.asarray(ax.get_xlim()),
            "ylim": np.asarray(ax.get_ylim()),
            "lines": [np.asarray(line.get_xydata(), dtype=np.float64) for line in ax.lines],
            "line_labels": [line.get_label() for line in ax.lines],
            "bars": np.asarray([p.get_height() for p in ax.patches], dtype=np.float64),
            "legend": [t.get_text() for t in legend.get_texts()] if legend is not None else [],
            "texts": [(t.get_text(), *t.get_position()) for t in ax.texts],
            "bound_lines": [np.asarray(seg, dtype=np.float64) for c in ax.collections for seg in c.get_segments()],
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "images": [np.asarray(im.get_array(), dtype=np.float64) for im in ax.images],
        })
    return out


_NUMBER = re.compile(r"-?\d+\.\d+")


def _same_text(got, want, path):
    """Equal texts, but for printed decimals one unit of their last digit apart."""
    assert _NUMBER.split(got) == _NUMBER.split(want), (path, got, want)
    for g, w in zip(_NUMBER.findall(got), _NUMBER.findall(want)):
        unit = 10.0 ** -len(w.split(".")[1])
        assert abs(float(g) - float(w)) <= unit * 1.0001, (path, got, want)


def _same(got, want, path="figure"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL), path
    elif isinstance(want, str):
        _same_text(got, want, path)
    else:
        assert got == want, path


def _figures(make_jax, make_port):
    want = _describe(make_jax()[1])
    plt.close("all")
    got = _describe(make_port()[1])
    plt.close("all")
    return got, want


def _streamed(cls_jax, cls_port, batches, **kwargs):
    import jax.numpy as jnp

    jm = cls_jax(**kwargs)
    tm = cls_port(device="cpu", **kwargs)
    for args in batches:
        jm.update(*[jnp.asarray(a) for a in args])
        tm.update(*[_t(a) for a in args])
    return jm, tm


def _cases():
    import torchmetrics_tpu as J
    import torchmetrics_tpu.classification as JC
    from torchmetrics_tpu.utilities import plot as jplot

    import torchmetrics_tpu_torch.classification as PC
    from torchmetrics_tpu_torch.utilities import plot as pplot

    import jax.numpy as jnp

    vec = _uniform(1, (5,))
    cm = _ints(2, (3, 3), 50)
    mlcm = _ints(3, (3, 2, 2), 20)
    probs = _uniform(4, (60, 4))
    probs = probs / probs.sum(-1, keepdims=True)
    mc_target = _ints(5, (60,), 4)
    ml_preds, ml_target = _uniform(6, (60, 3)), _ints(7, (60, 3), 2)
    b_preds, b_target = _uniform(8, (60,)), _ints(9, (60,), 2)

    def both(fn_jax, fn_port):
        return fn_jax, fn_port

    cases = {
        "scalar_with_bounds": both(
            lambda: jplot.plot_single_or_multi_val(jnp.asarray(0.7), lower_bound=0.0, upper_bound=1.0,
                                                   higher_is_better=True, name="Acc"),
            lambda: pplot.plot_single_or_multi_val(torch.tensor(0.7), lower_bound=0.0, upper_bound=1.0,
                                                   higher_is_better=True, name="Acc"),
        ),
        "vector_bar": both(
            lambda: jplot.plot_single_or_multi_val(jnp.asarray(vec), legend_name="cls"),
            lambda: pplot.plot_single_or_multi_val(_t(vec), legend_name="cls"),
        ),
        "dict_of_series": both(
            lambda: jplot.plot_single_or_multi_val({"a": jnp.asarray(vec), "b": jnp.asarray(0.5)}),
            lambda: pplot.plot_single_or_multi_val({"a": _t(vec), "b": torch.tensor(0.5)}),
        ),
        "sequence_of_vectors": both(
            lambda: jplot.plot_single_or_multi_val([jnp.asarray(vec), jnp.asarray(vec[::-1].copy())], legend_name="c"),
            lambda: pplot.plot_single_or_multi_val([_t(vec), _t(vec[::-1].copy())], legend_name="c"),
        ),
        "sequence_of_dicts": both(
            lambda: jplot.plot_single_or_multi_val([{"a": jnp.asarray(v), "b": jnp.asarray(2 * v)} for v in vec]),
            lambda: pplot.plot_single_or_multi_val([{"a": torch.tensor(v), "b": torch.tensor(2 * v)} for v in vec]),
        ),
        "confusion_matrix": both(
            lambda: jplot.plot_confusion_matrix(jnp.asarray(cm), labels=["x", "y", "z"]),
            lambda: pplot.plot_confusion_matrix(_t(cm), labels=["x", "y", "z"]),
        ),
        "multilabel_confusion_matrix": both(
            lambda: jplot.plot_confusion_matrix(jnp.asarray(mlcm)),
            lambda: pplot.plot_confusion_matrix(_t(mlcm)),
        ),
        "precomputed_curves": both(
            lambda: jplot.plot_curve((jnp.asarray(probs[:5].T), jnp.asarray(probs[5:10].T), None),
                                     score=jnp.asarray(vec[:4]), legend_name="L", name="N"),
            lambda: pplot.plot_curve((_t(probs[:5].T), _t(probs[5:10].T), None),
                                     score=_t(vec[:4]), legend_name="L", name="N"),
        ),
    }
    for thresholds in (None, 11):
        for cls in ("BinaryROC", "BinaryPrecisionRecallCurve"):
            jm, tm = _streamed(getattr(JC, cls), getattr(PC, cls), [(b_preds, b_target)], thresholds=thresholds)
            cases[f"{cls}_{thresholds}"] = (lambda m=jm: m.plot(score=True), lambda m=tm: m.plot(score=True))
        for cls in ("MulticlassROC", "MulticlassPrecisionRecallCurve"):
            jm, tm = _streamed(getattr(JC, cls), getattr(PC, cls), [(probs, mc_target)], num_classes=4,
                               thresholds=thresholds)
            cases[f"{cls}_{thresholds}"] = (lambda m=jm: m.plot(score=True), lambda m=tm: m.plot(score=True))
        for cls in ("MultilabelROC", "MultilabelPrecisionRecallCurve"):
            jm, tm = _streamed(getattr(JC, cls), getattr(PC, cls), [(ml_preds, ml_target)], num_labels=3,
                               thresholds=thresholds)
            cases[f"{cls}_{thresholds}"] = (lambda m=jm: m.plot(score=True), lambda m=tm: m.plot(score=True))
    jm, tm = _streamed(JC.MulticlassConfusionMatrix, PC.MulticlassConfusionMatrix, [(probs, mc_target)], num_classes=4)
    cases["confmat_binding"] = (lambda m=jm: m.plot(), lambda m=tm: m.plot())
    jm, tm = _streamed(JC.MulticlassAccuracy, PC.MulticlassAccuracy, [(probs, mc_target)], num_classes=4,
                       average=None)
    cases["per_class_accuracy"] = (lambda m=jm: m.plot(), lambda m=tm: m.plot())

    def collections(pkg, cls_pkg, wrap):
        return pkg.MetricCollection({"acc": cls_pkg.MulticlassAccuracy(num_classes=4, **wrap),
                                     "f1": cls_pkg.MulticlassF1Score(num_classes=4, **wrap)})

    jc, tc = collections(J, JC, {}), collections(tt, PC, {"device": "cpu"})
    jc.update(jnp.asarray(probs), jnp.asarray(mc_target))
    tc.update(_t(probs), _t(mc_target))
    cases["collection_together"] = (lambda: jc.plot(together=True), lambda: tc.plot(together=True))
    cases["collection_members"] = (lambda: (None, [fa[1] for fa in jc.plot()]), lambda: (None, [fa[1] for fa in tc.plot()]))

    jt, ptr = J.MetricTracker(JC.BinaryAccuracy()), tt.MetricTracker(PC.BinaryAccuracy(device="cpu"))
    for k in range(3):
        p, t = b_preds[20 * k:20 * (k + 1)], b_target[20 * k:20 * (k + 1)]
        jt.increment()
        jt.update(jnp.asarray(p), jnp.asarray(t))
        ptr.increment()
        ptr.update(_t(p), _t(t))
    cases["tracker"] = (lambda: jt.plot(), lambda: ptr.plot())
    return cases


def test_figures_match_the_jax_package():
    """Every plotting entry point draws the same figure from the same numpy values in both packages."""
    cases = _cases()
    assert len(cases) == 25
    for name, (make_jax, make_port) in cases.items():
        got, want = _figures(make_jax, make_port)
        try:
            _same(got, want)
        except AssertionError as err:
            raise AssertionError(f"{name}: {err}") from err


def test_plot_takes_values_off_the_device_only_at_the_call(monkeypatch):
    """``update`` and ``compute`` never read a value to the host for plotting; ``plot`` does, once per call."""
    from torchmetrics_tpu_torch.utilities import plot as pplot

    calls = []
    real = pplot._host
    monkeypatch.setattr(pplot, "_host", lambda x: calls.append(type(x).__name__) or real(x))
    m = BinaryROC(thresholds=5, device="cpu")
    m.update(_t(_uniform(0, (30,))), _t(_ints(0, (30,), 2)))
    m.compute()
    assert calls == []
    m.plot()
    assert calls and set(calls) == {"Tensor"}


def test_plot_without_matplotlib_raises_the_jax_error(monkeypatch):
    from torchmetrics_tpu_torch.utilities import plot as pplot

    from torchmetrics_tpu.utilities import plot as jplot

    assert pplot._error_msg == jplot._error_msg
    monkeypatch.setattr(pplot, "_MATPLOTLIB_AVAILABLE", False)
    for call in (lambda: pplot.plot_single_or_multi_val(torch.tensor(0.5)),
                 lambda: pplot.plot_confusion_matrix(np.eye(2)),
                 lambda: pplot.plot_curve((torch.zeros(2), torch.ones(2), None))):
        with pytest.raises(ModuleNotFoundError, match="matplotlib is required"):
            call()
