"""The port's perplexity and SQuAD on the CPU, against the JAX package.

Perplexity: the same seeded logits (float32, float16 and bfloat16, with and
without ``ignore_index``) through both packages, within 1e-5 relative; the
row-chunked log-softmax equals one pass over all rows. A target outside
``[0, V)`` gives what the JAX package gives: counted from the end in
``[-V, 0)``, NaN outside ``[-V, V)``. SQuAD: the sums of
exact match and F1 and the question count are equal to the JAX package's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as JF
import torchmetrics_tpu.text as JT
import torchmetrics_tpu_torch.functional.text as PF
import torchmetrics_tpu_torch.text as PT

# the modules by path: `functional.text` exports functions named like these modules
pperp = importlib.import_module("torchmetrics_tpu_torch.functional.text.perplexity")
psquad = importlib.import_module("torchmetrics_tpu_torch.functional.text.squad")
jsquad = importlib.import_module("torchmetrics_tpu.functional.text.squad")
PPL_RTOL = 1e-5
TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _logits(seed, shape=(3, 17, 50), ignore_share=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    t = rng.integers(0, shape[-1], shape[:2])
    t[rng.random(shape[:2]) < ignore_share] = -100
    return x, t


def _jax_logits(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else dtype)


@pytest.mark.parametrize("dtype", sorted(TORCH_DTYPES))
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_functional(dtype, ignore_index):
    x, t = _logits(1, ignore_share=0.1 if ignore_index is not None else 0.0)
    got = PF.perplexity(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), torch.from_numpy(t), ignore_index=ignore_index)
    want = JF.perplexity(_jax_logits(x, dtype), jnp.asarray(t), ignore_index=ignore_index)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PPL_RTOL)


def test_row_chunks_do_not_change_the_result(monkeypatch):
    x, t = _logits(2, shape=(4, 33, 70))
    whole = pperp._perplexity_update(torch.from_numpy(x), torch.from_numpy(t), -100)
    monkeypatch.setattr(pperp, "_CHUNK_BYTES", 4 * 70 * 5)  # 5 rows a chunk, a ragged last one
    chunked = pperp._perplexity_update(torch.from_numpy(x), torch.from_numpy(t), -100)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    assert whole[1].dtype == torch.int32 and int(whole[1]) == int((t != -100).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perplexity_class_over_updates(dtype):
    pm, jm = PT.Perplexity(ignore_index=-100, device="cpu"), JT.Perplexity(ignore_index=-100)
    xs, ts = [], []
    for seed in range(4):
        x, t = _logits(10 + seed)
        xs.append(x)
        ts.append(t)
        if seed % 2:
            pm.update(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), torch.from_numpy(t))
        else:
            pm(torch.from_numpy(x).to(TORCH_DTYPES[dtype]), torch.from_numpy(t))
        jm.update(_jax_logits(x, dtype), jnp.asarray(t))
    np.testing.assert_allclose(pm.compute().numpy(), np.asarray(jm.compute()), rtol=PPL_RTOL)
    assert float(pm.count) == float(jm.count)
    whole = PF.perplexity(torch.from_numpy(np.concatenate(xs)).to(TORCH_DTYPES[dtype]),
                          torch.from_numpy(np.concatenate(ts)), ignore_index=-100)
    np.testing.assert_allclose(pm.compute().numpy(), whole.numpy(), rtol=PPL_RTOL)


@pytest.mark.parametrize("vocab", [11, 200])
@pytest.mark.parametrize("bad", ["-100", "-1", "V", "V+39"])
@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_out_of_range_targets(vocab, bad, ignore_index):
    """A target in [-V, 0) counts from the end and one outside [-V, V) gives NaN, as in the JAX package; none raises."""
    rng = np.random.default_rng(vocab)
    x = (rng.standard_normal((2, 9, vocab)) * 3).astype(np.float32)
    t = rng.integers(0, vocab, (2, 9))
    t[0, 3] = {"-100": -100, "-1": -1, "V": vocab, "V+39": vocab + 39}[bad]
    t[1, 5] = -100
    got = PF.perplexity(torch.from_numpy(x), torch.from_numpy(t), ignore_index=ignore_index)
    want = np.asarray(JF.perplexity(jnp.asarray(x), jnp.asarray(t), ignore_index=ignore_index))
    np.testing.assert_allclose(got.numpy(), want, rtol=PPL_RTOL)  # NaN where the JAX package gives NaN
    pm, jm = PT.Perplexity(ignore_index=ignore_index, device="cpu"), JT.Perplexity(ignore_index=ignore_index)
    for rows in (slice(0, 1), slice(1, 2)):
        pm.update(torch.from_numpy(x[rows]), torch.from_numpy(t[rows]))
        jm.update(jnp.asarray(x[rows]), jnp.asarray(t[rows]))
    np.testing.assert_allclose(pm.compute().numpy(), np.asarray(jm.compute()), rtol=PPL_RTOL)
    assert float(pm.count) == float(jm.count)


@pytest.mark.parametrize(("preds", "target", "error"), [
    (np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64), "3 dimensions"),
    (np.zeros((2, 3, 4), np.float32), np.zeros((2,), np.int64), "2 dimensions"),
    (np.zeros((2, 3, 4), np.float32), np.zeros((2, 4), np.int64), "equaling first two"),
    (np.zeros((2, 3, 4), np.int64), np.zeros((2, 3), np.int64), "floating point"),
    (np.zeros((2, 3, 4), np.float32), np.zeros((2, 3), np.float32), "integer type"),
])
def test_perplexity_input_checks(preds, target, error):
    with pytest.raises((ValueError, TypeError), match=error):
        PF.perplexity(torch.from_numpy(preds), torch.from_numpy(target))
    with pytest.raises((ValueError, TypeError), match=error):
        JF.perplexity(jnp.asarray(preds), jnp.asarray(target))


ANSWERS = ["the cat sat", "The Cat", "on the mat", "1976", "an apple, a day!", "blue sky", "", "New York City"]


def _squad(seed, n):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        answers = [ANSWERS[int(j)] for j in rng.integers(0, len(ANSWERS), int(rng.integers(1, 4)))]
        guess = answers[0] if rng.random() < 0.4 else " ".join(rng.choice(" ".join(ANSWERS).split(), 3))
        preds.append({"prediction_text": guess, "id": f"q{seed}_{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{seed}_{i}"})
    return preds, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_squad_sums_equal_jax(seed):
    preds, target = _squad(seed, 40)
    got = psquad._squad_update(*psquad._flatten_inputs(preds, target), torch.device("cpu"))
    want = jsquad._squad_update(*jsquad._flatten_inputs(preds, target))
    for a, b in zip(got, want):
        assert a.dtype == (torch.int32 if a is got[2] else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, want = PF.squad(preds, target, device="cpu"), JF.squad(preds, target)
    for key in ("exact_match", "f1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_squad_class_unanswered_and_key_checks():
    preds, target = _squad(5, 30)
    pm, jm = PT.SQuAD(device="cpu"), JT.SQuAD()
    for lo in range(0, 30, 8):
        pm.update(preds[lo:lo + 8], target[lo:lo + 8])
        jm.update(preds[lo:lo + 8], target[lo:lo + 8])
    for key, value in jm.compute().items():
        np.testing.assert_array_equal(pm.compute()[key].numpy(), np.asarray(value))
    assert int(pm.total) == 30
    with pytest.warns(UserWarning, match="Unanswered question"):
        out = PF.squad(preds[:1], target[:2], device="cpu")
    assert float(out["exact_match"]) <= 50.0
    with pytest.raises(KeyError, match="prediction_text"):
        PF.squad([{"id": "1"}], target[:1], device="cpu")
    with pytest.raises(KeyError, match="'answers'"):
        PF.squad(preds[:1], [{"id": "1"}], device="cpu")
