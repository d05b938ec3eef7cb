"""The port's edit-distance family on the CPU, against the JAX package.

The same seeded strings go through the JAX functionals and classes and
through ``torchmetrics_tpu_torch`` with ``device="cpu"``. Distances, error
counts and totals must be equal; the rates (float32 divisions of equal
counts) within 1e-6 relative. Both DP routes are exercised: the dispatch
threshold is patched to 0 for the batched loop (as the JAX suite does for its
device kernel) and to a size no input reaches for the host DP.
"""

import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as JF
import torchmetrics_tpu.functional.text.helper as jhelper
import torchmetrics_tpu.text as JT
import torchmetrics_tpu_torch.functional.text as PF
import torchmetrics_tpu_torch.functional.text.helper as phelper
import torchmetrics_tpu_torch.text as PT
from torchmetrics_tpu_torch import MetricCollection

RATE_RTOL = 1e-6
ROUTES = {"host": 10**12, "device": 0}
FAMILY = [
    ("word_error_rate", "_wer_update", "wer", "WordErrorRate"),
    ("char_error_rate", "_cer_update", "cer", "CharErrorRate"),
    ("match_error_rate", "_mer_update", "mer", "MatchErrorRate"),
    ("word_information_lost", "_word_info_lost_update", "wil", "WordInfoLost"),
    ("word_information_preserved", "_word_info_preserved_update", "wip", "WordInfoPreserved"),
]


def _sentences(seed, n, vocab=12, max_words=14, empty_every=0):
    """Seeded word strings (Zipf-ish ids), with an empty string every ``empty_every`` rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if empty_every and i % empty_every == empty_every - 1:
            out.append("")
            continue
        k = int(rng.integers(1, max_words + 1))
        out.append(" ".join(f"w{min(int(rng.zipf(1.6)), vocab)}" for _ in range(k)))
    return out


def _pairs(seed, n, **kw):
    preds = _sentences(seed, n, **kw)
    rng = np.random.default_rng(seed + 1000)
    target = []
    for p in preds:
        words = p.split()
        words = [w if rng.random() > 0.3 else f"w{int(rng.integers(1, 12))}" for w in words]
        if rng.random() < 0.3:
            words.insert(int(rng.integers(0, len(words) + 1)), "extra")
        elif words and rng.random() < 0.3:
            words.pop(int(rng.integers(0, len(words))))
        target.append(" ".join(words))
    return preds, target


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    monkeypatch.setattr(phelper, "_HOST_DISPATCH_MAX_CELLS", ROUTES[request.param])
    monkeypatch.setattr(jhelper, "_HOST_DISPATCH_MAX_CELLS", ROUTES[request.param])
    return request.param


def _tokens(seed, n, alphabet):
    rng = np.random.default_rng(seed)
    return [[str(x) for x in rng.integers(0, alphabet, int(rng.integers(0, 20)))] for _ in range(n)]


@pytest.mark.parametrize("cost", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_levenshtein_routes_equal_the_host_dp_and_jax(cost, seed, monkeypatch):
    """Fuzz: both routes equal the single-pair DP and the JAX device kernel, empties included."""
    preds, tgts = _tokens(seed, 24, 5), _tokens(seed + 50, 24, 5)
    preds[0], tgts[1], preds[2], tgts[2] = [], [], [], []
    want = [jhelper._edit_distance_host(a, b, cost) for a, b in zip(preds, tgts)]
    monkeypatch.setattr(jhelper, "_HOST_DISPATCH_MAX_CELLS", 0)
    jax_device = np.asarray(jhelper._edit_distance_tokens(preds, tgts, substitution_cost=cost))
    for limit in ROUTES.values():
        monkeypatch.setattr(phelper, "_HOST_DISPATCH_MAX_CELLS", limit)
        got = phelper._edit_distance_tokens(preds, tgts, cost, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (24,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
        np.testing.assert_array_equal(got.numpy(), jax_device)
    assert [phelper._edit_distance_host(a, b, cost) for a, b in zip(preds, tgts)] == want


def test_levenshtein_batch_stops_at_the_longest_prediction():
    """Steps past every row's length change nothing: the loop may stop at the batch's longest prediction."""
    p_ids, p_len, t_ids, t_len = (torch.as_tensor(a) for a in phelper._encode_batch(
        [list("kitten"), list("ab"), []], [list("sitting"), list("abc"), list("xyz")]))
    short = phelper._levenshtein_batch(p_ids, p_len, t_ids, t_len, int(p_len.max()))
    padded = torch.cat([p_ids, torch.full((3, 5), phelper._PAD_ID, dtype=p_ids.dtype)], dim=1)
    long = phelper._levenshtein_batch(padded, p_len, t_ids, t_len, padded.shape[1])
    np.testing.assert_array_equal(short.numpy(), [3.0, 1.0, 3.0])
    np.testing.assert_array_equal(long.numpy(), short.numpy())


def test_route_is_chosen_by_size_alone(monkeypatch):
    """At most the threshold's cells (Σ len·len) the host DP runs; one cell more, the batched loop."""
    calls = []
    batch = phelper._levenshtein_batch
    monkeypatch.setattr(phelper, "_levenshtein_batch", lambda *a, **k: calls.append(1) or batch(*a, **k))
    preds, tgts = [list("abcd"), list("xy")], [list("abce"), list("xyz")]  # 16 + 6 = 22 cells
    monkeypatch.setattr(phelper, "_HOST_DISPATCH_MAX_CELLS", 22)
    host = phelper._edit_distance_tokens(preds, tgts, device="cpu")
    assert calls == []
    monkeypatch.setattr(phelper, "_HOST_DISPATCH_MAX_CELLS", 21)
    device = phelper._edit_distance_tokens(preds, tgts, device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(host.numpy(), device.numpy())


@pytest.mark.parametrize(("fn", "update", "module", "cls"), FAMILY, ids=[f[0] for f in FAMILY])
@pytest.mark.parametrize("seed", [3, 4])
def test_functional_counts_equal_and_rates_close(fn, update, module, cls, seed, route):
    preds, target = _pairs(seed, 40, empty_every=9)
    jmod = __import__(f"torchmetrics_tpu.functional.text.{module}", fromlist=[update])
    pmod = __import__(f"torchmetrics_tpu_torch.functional.text.{module}", fromlist=[update])
    want_counts = [np.asarray(x) for x in getattr(jmod, update)(preds, target)]
    got_counts = [x.numpy() for x in getattr(pmod, update)(preds, target, "cpu")]
    for got, want in zip(got_counts, want_counts):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got = getattr(PF, fn)(preds, target, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(JF, fn)(preds, target)), rtol=RATE_RTOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("cost", [1, 2])
def test_edit_distance_reductions(reduction, cost, route):
    preds, target = _pairs(11, 30, empty_every=7)
    want = np.asarray(JF.edit_distance(preds, target, substitution_cost=cost, reduction=reduction))
    got = PF.edit_distance(preds, target, substitution_cost=cost, reduction=reduction, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RATE_RTOL)
    jm, pm = JT.EditDistance(cost, reduction), PT.EditDistance(cost, reduction, device="cpu")
    for lo in range(0, 30, 8):
        jm.update(preds[lo:lo + 8], target[lo:lo + 8])
        pm.update(preds[lo:lo + 8], target[lo:lo + 8])
    np.testing.assert_allclose(pm.compute().numpy(), np.asarray(jm.compute()), rtol=RATE_RTOL)
    np.testing.assert_allclose(pm.compute().numpy(), got.numpy(), rtol=RATE_RTOL)


def test_edit_distance_of_nothing_is_int32_zero():
    got = PF.edit_distance([], [], device="cpu")
    assert got.dtype == torch.int32 and int(got) == 0 == int(JF.edit_distance([], []))


@pytest.mark.parametrize(("fn", "update", "module", "cls"), FAMILY, ids=[f[3] for f in FAMILY])
def test_class_over_updates_equals_functional_over_concatenation(fn, update, module, cls, route):
    preds, target = _pairs(21, 45, empty_every=11)
    pm, jm = getattr(PT, cls)(device="cpu"), getattr(JT, cls)()
    batch_vals = []
    for i, lo in enumerate(range(0, 45, 10)):
        p, t = preds[lo:lo + 10], target[lo:lo + 10]
        if i % 2:
            pm.update(p, t)
        else:
            batch_vals.append(pm(p, t).numpy())
            np.testing.assert_allclose(batch_vals[-1], np.asarray(getattr(JF, fn)(p, t)), rtol=RATE_RTOL)
        jm.update(p, t)
    whole = getattr(PF, fn)(preds, target, device="cpu")
    np.testing.assert_allclose(pm.compute().numpy(), whole.numpy(), rtol=RATE_RTOL)
    np.testing.assert_allclose(pm.compute().numpy(), np.asarray(jm.compute()), rtol=RATE_RTOL)
    for name in pm._defaults:
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)))


def test_wil_and_wip_share_a_compute_group_and_wer_mer_do_not():
    """WIL and WIP have identical states; WER and MER share ``errors`` but not ``total`` where a prediction is longer."""
    preds, target = _pairs(5, 32)
    assert any(len(p.split()) > len(t.split()) for p, t in zip(preds, target))
    mc = MetricCollection({
        "wer": PT.WordErrorRate(device="cpu"), "mer": PT.MatchErrorRate(device="cpu"),
        "wil": PT.WordInfoLost(device="cpu"), "wip": PT.WordInfoPreserved(device="cpu"),
        "cer": PT.CharErrorRate(device="cpu"),
    })
    mc.update(preds, target)
    mc.update(preds[::-1], target[::-1])
    groups = sorted(sorted(g) for g in mc.compute_groups.values())
    assert groups == [["cer"], ["mer"], ["wer"], ["wil", "wip"]]
    out = mc.compute()
    both = (preds + preds[::-1], target + target[::-1])
    for key, fn in (("wer", "word_error_rate"), ("mer", "match_error_rate"), ("wil", "word_information_lost"),
                    ("wip", "word_information_preserved"), ("cer", "char_error_rate")):
        np.testing.assert_allclose(out[key].numpy(), getattr(PF, fn)(*both, device="cpu").numpy(), rtol=RATE_RTOL)


def test_input_validation_matches_jax():
    with pytest.raises(ValueError, match="same length"):
        PF.word_error_rate(["a"], ["a", "b"], device="cpu")
    with pytest.raises(ValueError, match="string type"):
        PF.edit_distance([1], ["a"], device="cpu")
    with pytest.raises(ValueError, match="substitution_cost"):
        PT.EditDistance(substitution_cost=-1, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        PT.EditDistance(reduction="max", device="cpu")


def test_text_functionals_and_classes_default_to_cuda(monkeypatch):
    """Without ``device=`` the text functionals and classes resolve ``cuda``: with no GPU they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PF.word_error_rate(["a b"], ["a c"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PF.rouge_score(["a b"], ["a c"])
    for cls in ("WordErrorRate", "EditDistance", "BLEUScore", "ROUGEScore", "SQuAD", "Perplexity"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(PT, cls)()
