"""The port's default text encoders (no model given) on the CPU, against the JAX package.

``utilities/_threefry.py`` reproduces ``jax.random``'s threefry2x32 in its
partitionable mode: key words and random bits are held equal to
``jax.random`` bit for bit, normals within 1e-6 (XLA's float32 ErfInv
polynomial is ported; ``log1p`` may differ in the last bit). BERTScore
without a model is held against the JAX package's untrimmed oracle
(``_hash_embedding`` + ``_greedy_cosine_matching``) within 1e-6, InfoLM
without a model against ``infolm`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text.bert as jbert
from torchmetrics_tpu.functional.text.infolm import infolm as jax_infolm
from torchmetrics_tpu.text import InfoLM as JaxInfoLM
from torchmetrics_tpu_torch.functional.text import bert_score, infolm
from torchmetrics_tpu_torch.functional.text.bert import _HashTokenizer, _hash_embedding
from torchmetrics_tpu_torch.text import BERTScore, InfoLM
from torchmetrics_tpu_torch.utilities import _threefry as tf

IDS = np.concatenate([[0, 1, 2**31 - 1], np.random.default_rng(0).integers(0, 2**31 - 1, 61)]).astype(np.int64)
PREDS = ["the cat sat on the mat", "a quick brown fox jumps", "hello there general kenobi", "nothing here"]
TARGET = ["the cat is on the mat", "the quick brown fox jumped over", "hello there", "something else here too"]


def _jax_key(seed, i):
    return jax.random.fold_in(jax.random.PRNGKey(seed), int(i))


@pytest.mark.parametrize("seed", [0, 7])
def test_fold_in_key_words_equal_jax(seed):
    want = np.stack([np.asarray(jax.random.key_data(_jax_key(seed, i))) for i in IDS]).astype(np.int64)
    got = tf.fold_in(tf.prng_key(seed), torch.from_numpy(IDS)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tf.prng_key(seed).numpy(), np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize(("seed", "n"), [(0, 128), (7, 2048)])
def test_random_bits_equal_jax(seed, n):
    want = np.stack([np.asarray(jax.random.bits(_jax_key(seed, i), (n,))) for i in IDS[:8]]).astype(np.int64)
    got = tf.random_bits(tf.fold_in(tf.prng_key(seed), torch.from_numpy(IDS[:8])), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(("seed", "n"), [(0, 128), (7, 2048)])
def test_normals_within_1e6_of_jax(seed, n):
    want = jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed), i), (n,)))(
        jnp.asarray(IDS.astype(np.int32))
    )
    got = tf.normal_rows(seed, torch.from_numpy(IDS), n)
    assert got.dtype == torch.float32 and got.shape == (len(IDS), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_threefry2x32_known_answer():
    """Random123's known-answer vector for threefry2x32_20 with key and counter all ones."""
    ones = torch.tensor(0xFFFFFFFF)
    y0, y1 = tf.threefry2x32(ones, ones, ones, ones)
    assert (int(y0), int(y1)) == (0x1CB996FC, 0xBB002BE7)


def _encode(texts):
    return _HashTokenizer(16)(texts, 16)


def test_hash_embedding_matches_jax():
    enc = _encode(TARGET)
    want = jbert._hash_embedding(jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"]))
    got = _hash_embedding(torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _jax_untrimmed(preds, target, idf):
    """The JAX package's untrimmed oracle: ``_hash_embedding`` then ``_greedy_cosine_matching`` at full width."""
    p, t = _encode(preds), _encode(target)
    if idf:
        idf_map = jbert._compute_idf(t["input_ids"], t["attention_mask"])
        pw = jbert._idf_weights(p["input_ids"], p["attention_mask"], idf_map)
        tw = jbert._idf_weights(t["input_ids"], t["attention_mask"], idf_map)
    else:
        pw, tw = p["attention_mask"].astype(np.float32), t["attention_mask"].astype(np.float32)
    emb = lambda e: jbert._hash_embedding(jnp.asarray(e["input_ids"]), jnp.asarray(e["attention_mask"]))  # noqa: E731
    out = jbert._greedy_cosine_matching(
        emb(p), jnp.asarray(p["attention_mask"]), emb(t), jnp.asarray(t["attention_mask"]),
        jnp.asarray(pw), jnp.asarray(tw),
    )
    return dict(zip(("precision", "recall", "f1"), out))


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_without_a_model_matches_jax_untrimmed(idf):
    want = _jax_untrimmed(PREDS, TARGET, idf)
    got = bert_score(PREDS, TARGET, idf=idf, max_length=16, device="cpu")
    for key, value in want.items():
        assert got[key].shape == (len(PREDS),)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value), rtol=0, atol=1e-6)


def test_bertscore_metric_without_a_model_matches_jax_untrimmed():
    metric = BERTScore(max_length=16, device="cpu")
    metric.update(PREDS[:2], TARGET[:2])
    metric.update(PREDS[2:], TARGET[2:])
    got = metric.compute()
    want = _jax_untrimmed(PREDS, TARGET, idf=False)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value), rtol=0, atol=1e-6)
    same = bert_score(["hello there"], ["hello there"], device="cpu")
    assert abs(float(same["f1"][0]) - 1.0) < 1e-6


@pytest.mark.parametrize(("measure", "alpha", "beta"), [("kl_divergence", None, None), ("ab_divergence", 0.5, 0.7),
                                                        ("l2_distance", None, None)])
@pytest.mark.parametrize("idf", [False, True])
def test_infolm_without_a_model_matches_jax(measure, alpha, beta, idf):
    kw = dict(information_measure=measure, alpha=alpha, beta=beta, idf=idf, max_length=12,
              return_sentence_level_score=True)
    want_corpus, want = jax_infolm(PREDS, TARGET, **kw)
    got_corpus, got = infolm(PREDS, TARGET, device="cpu", **kw)
    assert got.shape == (len(PREDS),) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got_corpus), float(want_corpus), rtol=0, atol=1e-5)


def test_infolm_metric_without_a_model_matches_jax():
    jm, pm = JaxInfoLM(max_length=12), InfoLM(max_length=12, device="cpu")
    for a, b in ((0, 2), (2, 4)):
        jm.update(PREDS[a:b], TARGET[a:b])
        pm.update(PREDS[a:b], TARGET[a:b])
    np.testing.assert_allclose(float(pm.compute()), float(jm.compute()), rtol=0, atol=1e-5)
