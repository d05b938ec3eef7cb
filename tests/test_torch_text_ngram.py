"""The port's n-gram and MT metrics on the CPU, against the JAX package.

BLEU, SacreBLEU with each of its five tokenizers, chrF and chrF++, TER and
EED. The same seeded sentences (with punctuation, digits, HTML entities,
symbols and CJK characters, so every tokenizer rule fires) go through the JAX
functionals and classes and through ``torchmetrics_tpu_torch`` with
``device="cpu"``. N-gram counts, TER's edit counts and lengths are equal;
scores within 1e-6 relative (float32 logs and exps of equal counts; EED's DP
rows are the JAX package's own operations in its order).
"""

import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as JF
import torchmetrics_tpu.text as JT
import torchmetrics_tpu_torch.functional.text as PF
import torchmetrics_tpu_torch.text as PT
from torchmetrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as JaxTokenizer
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer

RTOL = 1e-6
WORDS = ["the", "cat", "sat", "on", "a", "mat", "Dog", "runs", "fast", "3.5", "1,000", "U.S.", "it's", "e-mail",
         "(note)", "end.", "yes!", "why?", "&amp;", "&quot;hi&quot;", "$5", "50%", "猫", "在", "垫子上", "x+y", "7-8",
         "naïve", "Straße", "—", "«quoted»"]


def _corpus(seed, n, refs=1):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n):
        words = [WORDS[int(rng.integers(0, len(WORDS)))] for _ in range(int(rng.integers(3, 16)))]
        preds.append(" ".join(words))
        row = []
        for _ in range(refs):
            ref = [w if rng.random() > 0.25 else WORDS[int(rng.integers(0, len(WORDS)))] for w in words]
            if rng.random() < 0.5 and len(ref) > 3:  # a moved span: TER's shifts
                k = int(rng.integers(1, 3))
                ref = ref[k:] + ref[:k]
            row.append(" ".join(ref))
        target.append(row)
    return preds, target


@pytest.mark.parametrize("tokenize", AVAILABLE_TOKENIZERS)
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacrebleu_tokenizers_equal_jax(tokenize, lowercase):
    preds, target = _corpus(1, 12)
    for line in preds + [t for row in target for t in row] + ["", "  a\nb-\nc <skipped> &lt;x&gt; 猫猫 12.5, 7-1"]:
        want = JaxTokenizer.tokenize(line, tokenize, lowercase)
        assert _SacreBLEUTokenizer.tokenize(line, tokenize, lowercase) == want
        assert _SacreBLEUTokenizer(tokenize, lowercase)(line) == want


def test_unknown_tokenizer_raises():
    with pytest.raises(ValueError, match="tokenize"):
        PT.SacreBLEUScore(tokenize="ja-mecab", device="cpu")


@pytest.mark.parametrize(("n_gram", "smooth", "weights"), [(4, False, None), (2, True, None), (3, False, [0.5, 0.3, 0.2]),
                                                          (1, True, None)])
@pytest.mark.parametrize("refs", [1, 3])
def test_bleu_counts_equal_and_score_close(n_gram, smooth, weights, refs):
    preds, target = _corpus(2 + refs, 24, refs)
    import torchmetrics_tpu.functional.text.bleu as jbleu
    import torchmetrics_tpu_torch.functional.text.bleu as pbleu

    want = jbleu._bleu_score_update(preds, target, n_gram)
    got = pbleu._bleu_score_update(preds, target, n_gram)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(PF.bleu_score(preds, target, n_gram, smooth, weights, device="cpu").numpy(),
                               np.asarray(JF.bleu_score(preds, target, n_gram, smooth, weights)), rtol=RTOL)


@pytest.mark.parametrize("tokenize", AVAILABLE_TOKENIZERS)
def test_sacre_bleu_functional_and_class(tokenize):
    preds, target = _corpus(7, 30, 2)
    want = np.asarray(JF.sacre_bleu_score(preds, target, tokenize=tokenize, smooth=True))
    np.testing.assert_allclose(PF.sacre_bleu_score(preds, target, tokenize=tokenize, smooth=True, device="cpu").numpy(),
                               want, rtol=RTOL)
    pm, jm = PT.SacreBLEUScore(tokenize=tokenize, smooth=True, device="cpu"), JT.SacreBLEUScore(tokenize=tokenize, smooth=True)
    for lo in range(0, 30, 8):
        pm.update(preds[lo:lo + 8], target[lo:lo + 8])
        jm.update(preds[lo:lo + 8], target[lo:lo + 8])
    for name in ("numerator", "denominator", "preds_len", "target_len"):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)))
    np.testing.assert_allclose(pm.compute().numpy(), want, rtol=RTOL)


def test_bleu_class_forward_and_zero_precision():
    preds, target = _corpus(9, 20)
    pm, jm = PT.BLEUScore(device="cpu"), JT.BLEUScore()
    for lo in range(0, 20, 5):
        np.testing.assert_allclose(pm(preds[lo:lo + 5], target[lo:lo + 5]).numpy(),
                                   np.asarray(jm(preds[lo:lo + 5], target[lo:lo + 5])), rtol=RTOL)
    np.testing.assert_allclose(pm.compute().numpy(), np.asarray(PF.bleu_score(preds, target, device="cpu")), rtol=RTOL)
    assert float(PF.bleu_score(["a b"], [["c d"]], device="cpu")) == 0.0 == float(JF.bleu_score(["a b"], [["c d"]]))


@pytest.mark.parametrize(("n_char_order", "n_word_order"), [(6, 2), (6, 0), (3, 1)])
@pytest.mark.parametrize(("lowercase", "whitespace"), [(False, False), (True, True)])
def test_chrf_functional_and_sentence_scores(n_char_order, n_word_order, lowercase, whitespace):
    preds, target = _corpus(11, 20, 2)
    kw = dict(n_char_order=n_char_order, n_word_order=n_word_order, lowercase=lowercase, whitespace=whitespace,
              return_sentence_level_score=True)
    got, got_s = PF.chrf_score(preds, target, device="cpu", **kw)
    want, want_s = JF.chrf_score(preds, target, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)


@pytest.mark.parametrize("n_word_order", [2, 0])
def test_chrf_class_counts_equal_jax(n_word_order):
    preds, target = _corpus(12, 25)
    pm = PT.CHRFScore(n_word_order=n_word_order, return_sentence_level_score=True, device="cpu")
    jm = JT.CHRFScore(n_word_order=n_word_order, return_sentence_level_score=True)
    for lo in range(0, 25, 7):
        pm.update(preds[lo:lo + 7], target[lo:lo + 7])
        jm.update(preds[lo:lo + 7], target[lo:lo + 7])
    for name in pm._defaults:
        if name != "sentence_chrf_score":
            np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)))
    (got, got_s), (want, want_s) = pm.compute(), jm.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)
    whole = PF.chrf_score(preds, target, n_word_order=n_word_order, device="cpu")
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL)


@pytest.mark.parametrize(("normalize", "no_punctuation", "lowercase", "asian_support"),
                         [(False, False, True, False), (True, False, True, False), (True, True, False, True),
                          (False, True, True, True)])
@pytest.mark.parametrize("refs", [1, 2])
def test_ter_functional_counts_and_sentence_scores(normalize, no_punctuation, lowercase, asian_support, refs):
    import torchmetrics_tpu.functional.text.ter as jter
    import torchmetrics_tpu_torch.functional.text.ter as pter

    preds, target = _corpus(20 + refs, 16, refs)
    flags = (normalize, no_punctuation, lowercase, asian_support)
    edits, length, sentence = pter._ter_update(preds, target, pter._TercomTokenizer(*flags))
    j_edits, j_length, j_sentence = jter._ter_update(preds, target, jter._TercomTokenizer(*flags),
                                                     0.0, 0.0, [])
    assert np.float32(edits) == np.asarray(j_edits) and np.float32(length) == np.asarray(j_length)
    np.testing.assert_array_equal(np.asarray(sentence, np.float32), np.concatenate([np.asarray(s) for s in j_sentence]))
    got, got_s = PF.translation_edit_rate(preds, target, *flags, return_sentence_level_score=True, device="cpu")
    want, want_s = JF.translation_edit_rate(preds, target, *flags, return_sentence_level_score=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_ter_class_equals_jax_and_the_functional():
    preds, target = _corpus(30, 24)
    pm, jm = PT.TranslationEditRate(return_sentence_level_score=True, device="cpu"), \
        JT.TranslationEditRate(return_sentence_level_score=True)
    for lo in range(0, 24, 5):
        pm.update(preds[lo:lo + 5], target[lo:lo + 5])
        jm.update(preds[lo:lo + 5], target[lo:lo + 5])
    assert float(pm.total_num_edits) == float(jm.total_num_edits)
    assert float(pm.total_tgt_length) == float(jm.total_tgt_length)
    (got, got_s), (want, want_s) = pm.compute(), jm.compute()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got.numpy(), PF.translation_edit_rate(preds, target, device="cpu").numpy(), rtol=RTOL)


@pytest.mark.parametrize("language", ["en", "ja"])
@pytest.mark.parametrize(("alpha", "rho", "deletion", "insertion"), [(2.0, 0.3, 0.2, 1.0), (1.0, 0.5, 0.5, 0.7)])
@pytest.mark.parametrize("refs", [1, 2])
def test_eed_functional_sentence_scores(language, alpha, rho, deletion, insertion, refs):
    preds, target = _corpus(40 + refs, 12, refs)
    kw = dict(language=language, alpha=alpha, rho=rho, deletion=deletion, insertion=insertion,
              return_sentence_level_score=True)
    got, got_s = PF.extended_edit_distance(preds, target, device="cpu", **kw)
    want, want_s = JF.extended_edit_distance(preds, target, **kw)
    assert got_s.dtype == torch.float32 and got_s.shape == (12,)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_eed_tie_rule_and_padding():
    """The first index within 1e-5 of the row minimum; batch padding changes no pair's score."""
    import torchmetrics_tpu.functional.text.eed as jeed
    import torchmetrics_tpu_torch.functional.text.eed as peed

    hyps = [" aaaa ", " ab ba ", " x ", " the cat sat on the mat . ", " "]
    refs = [" aa aa ", " ba ab ", " xxxxxxxxxx ", " a cat sat on a mat . ", " q "]
    batched = peed._eed_pairs(hyps, refs, 2.0, 0.3, 0.2, 1.0, torch.device("cpu")).numpy()
    singles = [peed._eed_function(h, r, device="cpu") for h, r in zip(hyps, refs)]
    np.testing.assert_array_equal(batched, np.asarray(singles, np.float32))
    np.testing.assert_allclose(batched, np.asarray(jeed._eed_pairs(hyps, refs, 2.0, 0.3, 0.2, 1.0)), rtol=RTOL)


def test_eed_class_equals_jax_and_the_functional():
    preds, target = _corpus(50, 20)
    pm, jm = PT.ExtendedEditDistance(return_sentence_level_score=True, device="cpu"), \
        JT.ExtendedEditDistance(return_sentence_level_score=True)
    for lo in range(0, 20, 6):
        pm.update(preds[lo:lo + 6], target[lo:lo + 6])
        jm.update(preds[lo:lo + 6], target[lo:lo + 6])
    (got, got_s), (want, want_s) = pm.compute(), jm.compute()
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), PF.extended_edit_distance(preds, target, device="cpu").numpy(), rtol=RTOL)
    empty = PT.ExtendedEditDistance(return_sentence_level_score=True, device="cpu")
    with pytest.warns(UserWarning, match="before the ``update``"):
        avg, scores = empty.compute()
    assert float(avg) == 0.0 and scores.shape == (0,)


def test_argument_validation():
    with pytest.raises(ValueError, match="n_char_order"):
        PT.CHRFScore(n_char_order=0, device="cpu")
    with pytest.raises(ValueError, match="normalize"):
        PF.translation_edit_rate(["a"], [["a"]], normalize=1, device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        PT.ExtendedEditDistance(alpha=2, device="cpu")
    with pytest.raises(ValueError, match="language"):
        PF.extended_edit_distance(["a"], ["a"], language="de", device="cpu")
    with pytest.raises(ValueError, match="weights"):
        PT.BLEUScore(n_gram=2, weights=[1.0], device="cpu")
    with pytest.raises(ValueError, match="Corpus has different size"):
        PF.bleu_score(["a"], [["a"], ["b"]], device="cpu")
