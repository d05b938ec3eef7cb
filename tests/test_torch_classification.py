"""Classification functionals of the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``torchmetrics_tpu``'s
functionals (JAX on the CPU) and ``torchmetrics_tpu_torch``'s (CPU tensors).
Counts are compared exactly; rates with ``atol=1e-6, rtol=1e-5``, the float32
rounding of one division and a short sum. Dtypes are compared by kind: JAX
runs with x64 off, so its counts are int32 where torch's sums give int64.
Scores are continuous random draws, so ``top_k``/``argmax`` meet no ties
(``jax.lax.top_k`` and ``torch.topk`` may break ties differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.classification as JF
import torchmetrics_tpu.utilities.data as jax_data
import torchmetrics_tpu_torch.functional.classification as TF
import torchmetrics_tpu_torch.utilities.data as torch_data

N, C, L, E = 48, 5, 4, 3
C_LARGE = 300  # crosses the 256-class split: the port's kernel wrapper, its plain version on the CPU


def assert_same(got, want):
    assert isinstance(got, torch.Tensor)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        assert got.dtype.kind in "iub", (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype.kind == "f", (got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def run_both(name, arrays, **kwargs):
    want = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    got = getattr(TF, name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    assert_same(got, want)


def _ignore(rng, target, ignore_index):
    if ignore_index is not None:
        target = target.copy()
        target[rng.random(target.shape) < 0.2] = ignore_index
    return target


def binary_inputs(seed, samplewise=False, logits=False, ignore_index=None):
    rng = np.random.default_rng(seed)
    shape = (N, E) if samplewise else (N,)
    preds = rng.normal(size=shape).astype(np.float32) if logits else rng.random(shape).astype(np.float32)
    return preds, _ignore(rng, rng.integers(0, 2, shape), ignore_index)


def multiclass_inputs(seed, c=C, samplewise=False, labels=False, ignore_index=None):
    rng = np.random.default_rng(seed)
    extra = (E,) if samplewise else ()
    target = rng.integers(0, c, (N, *extra))
    if labels:
        preds = rng.integers(0, c, (N, *extra))
    else:
        preds = rng.normal(size=(N, c, *extra)).astype(np.float32)
    return preds, _ignore(rng, target, ignore_index)


def multilabel_inputs(seed, samplewise=False, logits=False, ignore_index=None):
    rng = np.random.default_rng(seed)
    shape = (N, L, E) if samplewise else (N, L)
    preds = rng.normal(size=shape).astype(np.float32) if logits else rng.random(shape).astype(np.float32)
    return preds, _ignore(rng, rng.integers(0, 2, shape), ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("name", ["binary_stat_scores", "binary_accuracy"])
@pytest.mark.parametrize("logits", [False, True])
def test_binary_stats(name, multidim_average, ignore_index, logits):
    arrays = binary_inputs(1, multidim_average == "samplewise", logits, ignore_index)
    run_both(name, arrays, multidim_average=multidim_average, ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("normalize", ["true", "pred", "all", "none", None])
def test_binary_confusion_matrix(normalize, ignore_index):
    run_both("binary_confusion_matrix", binary_inputs(2, ignore_index=ignore_index), normalize=normalize,
             ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("name", ["multiclass_stat_scores", "multiclass_accuracy"])
def test_multiclass_stats(name, average, top_k, multidim_average, ignore_index):
    arrays = multiclass_inputs(3, samplewise=multidim_average == "samplewise", ignore_index=ignore_index)
    run_both(name, arrays, num_classes=C, average=average, top_k=top_k, multidim_average=multidim_average,
             ignore_index=ignore_index)


@pytest.mark.parametrize("average", ["micro", "macro", "none"])
@pytest.mark.parametrize("name", ["multiclass_stat_scores", "multiclass_accuracy"])
def test_multiclass_stats_from_labels(name, average):
    run_both(name, multiclass_inputs(4, labels=True), num_classes=C, average=average)


@pytest.mark.parametrize("top_k", [1, 2])
def test_multiclass_accuracy_many_classes(top_k):
    run_both("multiclass_accuracy", multiclass_inputs(5, c=C_LARGE, ignore_index=-1), num_classes=C_LARGE,
             average="macro", top_k=top_k, ignore_index=-1)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("normalize", ["true", "pred", "all", "none", None])
@pytest.mark.parametrize("c", [C, C_LARGE])
def test_multiclass_confusion_matrix(c, normalize, ignore_index):
    run_both("multiclass_confusion_matrix", multiclass_inputs(6, c=c, ignore_index=ignore_index), num_classes=c,
             normalize=normalize, ignore_index=ignore_index)


@pytest.mark.parametrize("c", [C, C_LARGE])
def test_multiclass_confusion_matrix_from_label_maps(c):
    """(N, E) label maps, as a segmentation evaluator passes them."""
    run_both("multiclass_confusion_matrix", multiclass_inputs(7, c=c, samplewise=True, labels=True, ignore_index=-1),
             num_classes=c, ignore_index=-1)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("name", ["multilabel_stat_scores", "multilabel_accuracy"])
def test_multilabel_stats(name, average, multidim_average, ignore_index):
    arrays = multilabel_inputs(8, multidim_average == "samplewise", logits=average == "macro", ignore_index=ignore_index)
    run_both(name, arrays, num_labels=L, average=average, multidim_average=multidim_average,
             ignore_index=ignore_index)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("normalize", ["true", "pred", "all", "none", None])
def test_multilabel_confusion_matrix(normalize, ignore_index):
    run_both("multilabel_confusion_matrix", multilabel_inputs(9, ignore_index=ignore_index), num_labels=L,
             normalize=normalize, ignore_index=ignore_index)


TASKS = {
    "binary": (binary_inputs(10), {}),
    "multiclass": (multiclass_inputs(11), {"num_classes": C}),
    "multilabel": (multilabel_inputs(12), {"num_labels": L}),
}


@pytest.mark.parametrize("task", sorted(TASKS))
@pytest.mark.parametrize("name", ["stat_scores", "accuracy", "confusion_matrix"])
def test_task_dispatchers(name, task):
    arrays, kwargs = TASKS[task]
    run_both(name, arrays, task=task, **kwargs)


def _bad_binary_target():
    preds, target = binary_inputs(13)
    target = target.copy()
    target[0] = 2
    return preds, target


def _bad_multiclass_target():
    preds, target = multiclass_inputs(14)
    target = target.copy()
    target[0] = C
    return preds, target


@pytest.mark.parametrize(
    ("name", "arrays", "kwargs", "error"),
    [
        ("binary_stat_scores", _bad_binary_target(), {}, RuntimeError),
        ("binary_confusion_matrix", _bad_binary_target(), {}, RuntimeError),
        ("multiclass_accuracy", _bad_multiclass_target(), {"num_classes": C}, RuntimeError),
        ("multiclass_stat_scores", multiclass_inputs(15), {"num_classes": C, "top_k": C + 1}, ValueError),
        ("multiclass_confusion_matrix", multiclass_inputs(16), {"num_classes": C, "normalize": "rows"}, ValueError),
        ("multilabel_accuracy", multilabel_inputs(17), {"num_labels": L + 1}, ValueError),
        ("binary_accuracy", binary_inputs(18), {"threshold": 2.0}, ValueError),
    ],
)
def test_validation_raises_like_jax(name, arrays, kwargs, error):
    with pytest.raises(error) as jax_err:
        getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    with pytest.raises(error) as torch_err:
        getattr(TF, name)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    assert str(torch_err.value).split(":")[0] == str(jax_err.value).split(":")[0]


@pytest.mark.parametrize(
    ("name", "kwargs", "make"),
    [
        ("to_onehot", {"num_classes": C}, lambda rng: rng.integers(0, C, (N, E))),
        ("to_onehot", {}, lambda rng: rng.integers(0, C, N)),
        ("select_topk", {"topk": 1}, lambda rng: rng.normal(size=(N, C)).astype(np.float32)),
        ("select_topk", {"topk": 2, "dim": 1}, lambda rng: rng.normal(size=(N, C, E)).astype(np.float32)),
    ],
)
def test_data_helpers(name, kwargs, make):
    x = make(np.random.default_rng(19))
    assert_same(getattr(torch_data, name)(torch.from_numpy(x), **kwargs), getattr(jax_data, name)(jnp.asarray(x), **kwargs))
