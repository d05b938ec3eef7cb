"""The port's nominal-association metrics on the CPU, against the JAX package.

The four pair functions with ``bias_correction`` on and off and both NaN
strategies, the four column-pair matrices, Fleiss' kappa in both modes, and
the classes with and without ``num_classes`` (streamed in batches), on the
same seeded numpy inputs. Float32 values agree within ``RTOL``/``ATOL``:
the same float32 formulas, summed in another order (Theil's U subtracts two
entropies, so its last digits move the most). With ``num_classes`` a pair
holding a value outside ``[0, C)`` (-1, C, C + 5 below) counts nowhere in
either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.nominal as JF
import torchmetrics_tpu.nominal as JN
import torchmetrics_tpu_torch.functional.nominal as PF
import torchmetrics_tpu_torch.nominal as PN

RTOL = 1e-5
ATOL = 1e-6
PAIR_FUNCTIONS = ["cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u"]
BIASED = {"cramers_v", "tschuprows_t"}
MATRICES = [f"{name}_matrix" for name in PAIR_FUNCTIONS]
CLASSES = {"cramers_v": "CramersV", "tschuprows_t": "TschuprowsT",
           "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient", "theils_u": "TheilsU"}


def pairs(seed, n=300, kp=5, kt=4, nan_share=0.05):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, kp, n).astype(np.float64)
    target = (preds + rng.integers(0, 2, n)).clip(0, kt - 1)  # associated, not equal
    preds[rng.random(n) < nan_share] = np.nan
    target[rng.random(n) < nan_share] = np.nan
    return preds, target


def both(name, *arrays, **kwargs):
    got = getattr(PF, name)(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kwargs)
    want = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kwargs)
    return got, np.asarray(want)


# (name, bias_correction): Pearson's coefficient and Theil's U take no bias correction
PAIR_CASES = [(name, bias) for name in PAIR_FUNCTIONS for bias in ((True, False) if name in BIASED else (None,))]


@pytest.mark.parametrize(("name", "bias_correction"), PAIR_CASES)
@pytest.mark.parametrize(("nan_strategy", "nan_replace_value"), [("replace", 0.0), ("replace", 7), ("drop", None)])
def test_pair_functions_match_jax(name, bias_correction, nan_strategy, nan_replace_value):
    kwargs = {"nan_strategy": nan_strategy, "nan_replace_value": nan_replace_value}
    if bias_correction is not None:
        kwargs["bias_correction"] = bias_correction
    got, want = both(name, *pairs(len(name)), **kwargs)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
def test_pair_functions_on_integer_and_independent_series(name):
    rng = np.random.default_rng(1)
    preds, target = rng.integers(0, 6, 500), rng.integers(0, 3, 500)
    got, want = both(name, preds, target)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    got, want = both(name, preds, preds)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_matrices_match_jax(name, nan_strategy):
    rng = np.random.default_rng(2)
    matrix = rng.integers(0, 3, (150, 4)).astype(np.float64)
    matrix[:, 1] = (matrix[:, 0] + rng.integers(0, 2, 150)) % 3
    matrix[rng.random(matrix.shape) < 0.03] = np.nan
    got, want = both(name, matrix, nan_strategy=nan_strategy)
    assert got.dtype == torch.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.diagonal(got.numpy()), np.ones(4, np.float32))
    if name != "theils_u_matrix":
        np.testing.assert_array_equal(got.numpy(), got.numpy().T)


def test_theils_u_matrix_is_conditional_on_the_column():
    rng = np.random.default_rng(3)
    matrix = rng.integers(0, 4, (200, 3))
    out = PF.theils_u_matrix(torch.from_numpy(matrix))
    for i, j in ((0, 1), (1, 0), (2, 0)):
        np.testing.assert_allclose(out[i, j].numpy(), PF.theils_u(torch.from_numpy(matrix[:, i]),
                                                                  torch.from_numpy(matrix[:, j])).numpy())


@pytest.mark.parametrize("bias_correction", [True, False])
def test_biased_matrices(bias_correction):
    matrix = np.random.default_rng(4).integers(0, 3, (120, 3))
    for name in ("cramers_v_matrix", "tschuprows_t_matrix"):
        got, want = both(name, matrix, bias_correction=bias_correction)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_fleiss_kappa_both_modes(seed):
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(7, np.full(5, 0.2), size=60)  # 7 raters a subject
    got, want = both("fleiss_kappa", counts, mode="counts")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    uneven = rng.integers(0, 5, (40, 4))  # unequal rater counts: the largest row sum is the rater count
    got, want = both("fleiss_kappa", uneven, mode="counts")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    probs = rng.random((50, 6, 9)).astype(np.float32)  # more categories than some raters pick
    got, want = both("fleiss_kappa", probs, mode="probs")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fleiss_kappa_errors():
    with pytest.raises(ValueError, match="Argument `mode` must be one of"):
        PF.fleiss_kappa(torch.ones((3, 2), dtype=torch.int64), mode="ratios")
    with pytest.raises(ValueError, match="be none floating point"):
        PF.fleiss_kappa(torch.ones((3, 2)), mode="counts")
    with pytest.raises(ValueError, match="be none floating point"):
        PF.fleiss_kappa(torch.ones((3, 2, 2), dtype=torch.int64), mode="counts")
    with pytest.raises(ValueError, match="be floating point"):
        PF.fleiss_kappa(torch.ones((3, 2, 4), dtype=torch.int64), mode="probs")
    with pytest.raises(ValueError, match="be floating point"):
        PF.fleiss_kappa(torch.ones((3, 2)), mode="probs")
    with pytest.raises(ValueError, match="Argument `mode` must be one of"):
        PN.FleissKappa(mode="ratios", device="cpu")


def test_nan_and_num_classes_errors():
    x = torch.tensor([0, 1, 1])
    with pytest.raises(ValueError, match="`nan_strategy` is expected to be one of"):
        PF.cramers_v(x, x, nan_strategy="ignore")
    with pytest.raises(ValueError, match="`nan_replace` is expected to be of a type `int` or `float`"):
        PF.theils_u(x, x, nan_replace_value=None)
    with pytest.raises(ValueError, match="`nan_strategy` is expected to be one of"):
        PF.tschuprows_t_matrix(torch.zeros((3, 2)), nan_strategy="mean")
    for bad in (1, 2.5, "3"):
        with pytest.raises(ValueError, match="`num_classes` must be an integer larger than 1"):
            PN.CramersV(num_classes=bad, device="cpu")
    with pytest.raises(ValueError, match="`nan_strategy` is expected to be one of"):
        PN.TheilsU(nan_strategy="zero", device="cpu")


def test_category_ids_round_through_float32():
    """A category id above 2**24 goes through float32 in both packages, so 2**24 + 1 meets 2**24."""
    preds = np.array([2**24, 2**24 + 1, 3, 3, 5, 5])
    target = np.array([0, 1, 0, 1, 0, 1])
    for name in PAIR_FUNCTIONS:
        got, want = both(name, preds, target)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_classes_with_num_classes_ignore_out_of_range_values(name, nan_strategy):
    c = 6
    rng = np.random.default_rng(5)
    preds = rng.integers(0, c, 240).astype(np.float64)
    target = ((preds + rng.integers(0, 3, 240)) % c).astype(np.float64)
    preds[::17], target[5::19], preds[9::23] = -1, c, c + 5  # outside [0, C): these pairs count nowhere
    preds[3::29] = np.nan
    kwargs = {"nan_strategy": nan_strategy}
    if name in BIASED:
        kwargs["bias_correction"] = True
    ours = getattr(PN, CLASSES[name])(num_classes=c, device="cpu", **kwargs)
    theirs = getattr(JN, CLASSES[name])(num_classes=c, **kwargs)
    for lo in range(0, 240, 80):
        ours.update(torch.from_numpy(preds[lo:lo + 80]), torch.from_numpy(target[lo:lo + 80]))
        theirs.update(jnp.asarray(preds[lo:lo + 80]), jnp.asarray(target[lo:lo + 80]))
    np.testing.assert_array_equal(ours.confmat.numpy(), np.asarray(theirs.confmat))
    assert ours.confmat.dtype == torch.float32 and ours.confmat.shape == (c, c)
    kept = ~np.isnan(preds) if nan_strategy == "drop" else np.ones(len(preds), dtype=bool)
    p = np.nan_to_num(preds, nan=0.0)  # "replace" puts a NaN at category 0
    in_range = kept & (p >= 0) & (p < c) & (target >= 0) & (target < c)
    assert 0 < float(ours.confmat.sum()) == in_range.sum() < len(preds)
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", PAIR_FUNCTIONS)
def test_classes_without_num_classes(name):
    preds, target = pairs(6, n=240)
    ours = getattr(PN, CLASSES[name])(device="cpu", nan_strategy="drop")
    theirs = getattr(JN, CLASSES[name])(nan_strategy="drop")
    for lo in range(0, 240, 60):
        ours.update(torch.from_numpy(preds[lo:lo + 60]), torch.from_numpy(target[lo:lo + 60]))
        theirs.update(jnp.asarray(preds[lo:lo + 60]), jnp.asarray(target[lo:lo + 60]))
    got = ours.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.compute()), rtol=RTOL, atol=ATOL)
    # the stream equals the functional on the whole series
    np.testing.assert_allclose(got.numpy(), both(name, preds, target, nan_strategy="drop")[0].numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_class(mode):
    rng = np.random.default_rng(7)
    data = rng.multinomial(5, np.full(4, 0.25), size=90) if mode == "counts" else rng.random((90, 4, 5))
    ours, theirs = PN.FleissKappa(mode=mode, device="cpu"), JN.FleissKappa(mode=mode)
    for lo in range(0, 90, 30):
        ours.update(torch.from_numpy(data[lo:lo + 30]))
        theirs.update(jnp.asarray(data[lo:lo + 30]))
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=RTOL, atol=ATOL)


def test_confmat_state_merges_by_sum():
    a, b = PN.CramersV(num_classes=4, device="cpu"), PN.CramersV(num_classes=4, device="cpu")
    x = torch.tensor([0, 1, 2, 3, 1, 2, 0, 0])
    y = torch.tensor([0, 1, 2, 3, 2, 2, 1, 0])
    a.update(x[:4], y[:4])
    b.update(x[4:], y[4:])
    a.merge_state(b)
    whole = PN.CramersV(num_classes=4, device="cpu")
    whole.update(x, y)
    np.testing.assert_array_equal(a.confmat.numpy(), whole.confmat.numpy())
    assert float(a.compute()) == float(whole.compute())


def test_exports():
    assert sorted(PN.__all__) == sorted(JN.__all__) and sorted(PF.__all__) == sorted(JF.__all__)
