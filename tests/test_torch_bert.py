"""The port's BERT encoder, BERTScore and InfoLM on the CPU, against the JAX package.

Weights are the port's seeded random ones (HF's initializer, then LayerNorm
scales and shifts drawn at random so a swapped or dropped affine shows),
written to the JAX package's flat ``.npz`` by the port's converter; both
packages load that one file. The config (vocab 120, hidden 128, 2 heads,
2 layers) makes the JAX side take its Pallas LayerNorm kernel, in interpret
mode, checked for silent degradation. Hidden states and logits agree to
``rtol=1e-4, atol=1e-5`` (the JAX package's own tolerance against HF's
``BertModel``); scores to ``1e-5``. InfoLM cases use L <= 16.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torchmetrics_tpu import _kernels as K
from torchmetrics_tpu._kernels.dispatch import reset_degradations
from torchmetrics_tpu.functional.text import bert_score as jax_bert_score
from torchmetrics_tpu.functional.text.infolm import infolm as jax_infolm
from torchmetrics_tpu.text import BERTScore as JaxBERTScore
from torchmetrics_tpu.text import InfoLM as JaxInfoLM
from torchmetrics_tpu.text._bert_encoder import BertEncoderExtractor as JaxEncoder
from torchmetrics_tpu.text._bert_encoder import BertMLMExtractor as JaxMLM
from torchmetrics_tpu.text._bert_encoder import _BertWithHead as JaxBertWithHead
from torchmetrics_tpu.text._bert_encoder import _config_from_npz
from torchmetrics_tpu_torch.functional.text import bert_score, infolm
from torchmetrics_tpu_torch.text import BERTScore, InfoLM
from torchmetrics_tpu_torch.text._bert_encoder import (
    BertConfig,
    BertEncoderExtractor,
    BertMLMExtractor,
    _BertWithHead,
    _LayerNorm,
    init_bert_weights_,
)
from torchmetrics_tpu_torch.utilities.convert import (
    bert_state_dict_from_variables,
    bert_variables_from_state_dict,
    build_on_cpu,
)

ka = importlib.import_module("torchmetrics_tpu_torch._kernels.attention")
CONFIG = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256, max_position=64)
SPECIAL = {"pad_token_id": 0, "cls_token_id": 101, "sep_token_id": 102, "mask_token_id": 103}
MEASURES = [
    ("kl_divergence", None, None),
    ("alpha_divergence", 0.5, None),
    ("ab_divergence", 0.5, 0.7),
    ("l2_distance", None, None),
    ("fisher_rao_distance", None, None),
]
# Fisher-Rao is 2 arccos(sum sqrt(p t)) with the sum within 1e-5 of 1 for this
# random model, where arccos' slope 1/sqrt(1 - x^2) turns float32 round-off of
# the sum (~1e-7) into ~3e-5 of the distance
INFOLM_ATOL = {"fisher_rao_distance": 1e-4}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernels (interpret mode on the CPU) and must not degrade to XLA."""
    reset_degradations()
    monkeypatch.setenv(K.KERNELS_ENV, "pallas")
    yield
    assert not K.degraded_kernels()
    reset_degradations()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    config = BertConfig(**CONFIG, with_mlm_head=True)
    net = init_bert_weights_(build_on_cpu(_BertWithHead, config), seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, _LayerNorm):
                module.weight.uniform_(0.5, 1.5, generator=gen)
                module.bias.normal_(0.0, 0.1, generator=gen)
    flat = bert_variables_from_state_dict(net.state_dict(), config)
    npz = tmp_path_factory.mktemp("bert") / "bert.npz"
    np.savez(npz, **flat)
    return {"state": net.state_dict(), "flat": flat, "npz": str(npz)}


@pytest.fixture(scope="module")
def models(weights):
    npz = weights["npz"]
    return {
        "jax_encoder": JaxEncoder(npz), "jax_mlm": JaxMLM(npz),
        "encoder": BertEncoderExtractor(npz, device="cpu"), "mlm": BertMLMExtractor(npz, device="cpu"),
    }


def _batch(seed, bsz=4, length=16, min_len=3):
    """Pre-tokenized sentences: [CLS] words [SEP], zero-padded, ragged."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((bsz, length), np.int64)
    mask = np.zeros((bsz, length), np.int64)
    for i, n in enumerate(rng.integers(min_len, length + 1, bsz)):
        ids[i, :n] = rng.integers(104, CONFIG["vocab_size"], n)
        ids[i, 0], ids[i, n - 1] = SPECIAL["cls_token_id"], SPECIAL["sep_token_id"]
        mask[i, :n] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _perturbed(enc, seed, share=0.3):
    """The same sentences with about ``share`` of their words replaced."""
    rng = np.random.default_rng(seed)
    ids = enc["input_ids"].copy()
    swap = (rng.random(ids.shape) < share) & (ids >= 104)
    ids[swap] = rng.integers(104, CONFIG["vocab_size"], int(swap.sum()))
    return {"input_ids": ids, "attention_mask": enc["attention_mask"].copy()}


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- converter

def test_converter_writes_the_jax_layout_and_round_trips(weights):
    cfg = _config_from_npz(weights["flat"])
    dummy = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(JaxBertWithHead(cfg).init, jax.random.PRNGKey(0), dummy, dummy)
    want = {"/".join(k): tuple(v.shape) for k, v in flatten_dict(shapes).items()}
    params = {k: v.shape for k, v in weights["flat"].items() if not k.startswith("config/")}
    assert params == want
    state, config = bert_state_dict_from_variables(weights["flat"])
    assert vars(config) == vars(BertConfig(**CONFIG, with_mlm_head=True))
    assert state.keys() == weights["state"].keys()
    assert all(torch.equal(state[k], weights["state"][k]) for k in state)


def test_converter_reads_convert_weights_output_for_hf_bert(tmp_path):
    transformers = pytest.importorskip("transformers")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from convert_weights import convert_bert_state_dict

    torch.manual_seed(0)
    hf = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=97, hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )).eval()
    npz = tmp_path / "hf.npz"
    np.savez(npz, **convert_bert_state_dict(hf.state_dict(), num_heads=4))
    enc = _batch(seed=9, bsz=3, length=12)
    enc["input_ids"] %= 97
    ids, mask = torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"])
    with torch.no_grad():
        out = hf(ids, attention_mask=mask, output_hidden_states=True)
    for layer in range(3):
        got = BertEncoderExtractor(str(npz), num_layers=layer, device="cpu")(ids, mask)
        _close(got, out.hidden_states[layer], rtol=1e-4, atol=1e-5)
    _close(BertMLMExtractor(str(npz), device="cpu")(ids, mask), out.logits, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ encoder

@pytest.mark.parametrize("num_layers", [0, 1, 2, -2, None])
def test_encoder_hidden_states_match_jax(weights, num_layers):
    enc = _batch(seed=1, length=21)
    want = JaxEncoder(weights["npz"], num_layers=num_layers)(jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"]))
    for unfused in (False, True):
        ours = BertEncoderExtractor(weights["npz"], num_layers=num_layers, unfused=unfused, device="cpu")
        got = ours(enc["input_ids"], enc["attention_mask"])
        assert got.shape == (4, 21, 128) and got.dtype == torch.float32
        _close(got, want, rtol=1e-4, atol=1e-5)


def test_bf16_encoder_matches_jax(weights):
    enc = _batch(seed=2)
    want = JaxEncoder(weights["npz"], compute_dtype=jnp.bfloat16)(jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"]))
    got = BertEncoderExtractor(weights["npz"], compute_dtype=torch.bfloat16, device="cpu")(enc["input_ids"], enc["attention_mask"])
    want = torch.from_numpy(np.array(want))
    # the frameworks round bf16 at other places; a wrong graph is ~1 away
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) < 2e-2


def test_mlm_logits_match_jax(models):
    enc = _batch(seed=3)
    want = np.asarray(models["jax_mlm"](jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"])))
    got = models["mlm"](enc["input_ids"], enc["attention_mask"])
    assert got.shape == (4, 16, CONFIG["vocab_size"])
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(models["mlm"].logits_at(enc["input_ids"], enc["attention_mask"], 5), want[:, 5], rtol=1e-4, atol=1e-5)


def test_encoder_takes_the_plain_kernels_on_cpu(models):
    ka.attention.launches = ka.layernorm_residual.launches = 0
    enc = _batch(seed=4)
    models["encoder"](enc["input_ids"], enc["attention_mask"])
    assert ka.attention.launches == 0 and ka.layernorm_residual.launches == 0


# ---------------------------------------------------------------- BERTScore

@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_matches_jax(models, idf):
    target = _batch(seed=5, bsz=6)
    preds = _perturbed(target, seed=6)
    want = jax_bert_score(preds, target, model=models["jax_encoder"], idf=idf)
    got = bert_score(preds, target, model=models["encoder"], idf=idf)
    for key in ("precision", "recall", "f1"):
        assert got[key].shape == (6,)
        _close(got[key], want[key])


@pytest.mark.parametrize("idf", [False, True])
def test_bertscore_metric_matches_jax(weights, models, idf):
    jm = JaxBERTScore(model=models["jax_encoder"], idf=idf, max_length=16)
    pm = BERTScore(weights_path=weights["npz"], idf=idf, max_length=16, device="cpu")
    assert set(pm.state_dict(all_states=True)) == set(jm.state_dict(all_states=True))
    for seed in (7, 8):
        target = _batch(seed=seed, length=12)
        preds = _perturbed(target, seed=seed + 10)
        jm.update(preds, target)
        pm.update(preds, target)
    target = _batch(seed=9, bsz=3)
    preds = _perturbed(target, seed=19)
    batch_want, batch_got = jm(preds, target), pm(preds, target)
    want, got = jm.compute(), pm.compute()
    for key in ("precision", "recall", "f1"):
        _close(batch_got[key], batch_want[key])
        assert got[key].shape == (11,)
        _close(got[key], want[key])


# ------------------------------------------------------------------- InfoLM

@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("measure,alpha,beta", MEASURES, ids=[m[0] for m in MEASURES])
def test_infolm_matches_jax(models, measure, alpha, beta, idf):
    target = _batch(seed=11, bsz=3, length=10)
    preds = _perturbed(target, seed=12, share=0.5)
    kw = dict(information_measure=measure, alpha=alpha, beta=beta, idf=idf, special_tokens_map=SPECIAL,
              return_sentence_level_score=True)
    want_corpus, want = jax_infolm(preds, target, model=models["jax_mlm"], **kw)
    got_corpus, got = infolm(preds, target, model=models["mlm"], **kw)
    assert got.shape == (3,)
    atol = INFOLM_ATOL.get(measure, 1e-6)
    _close(got, want, rtol=1e-4, atol=atol)
    _close(got_corpus, want_corpus, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("idf", [False, True])
def test_infolm_metric_matches_jax(weights, models, idf):
    jm = JaxInfoLM(model=models["jax_mlm"], idf=idf, max_length=12, special_tokens_map=SPECIAL)
    pm = InfoLM(weights_path=weights["npz"], idf=idf, max_length=12, special_tokens_map=SPECIAL, device="cpu")
    for seed in (13, 14):
        target = _batch(seed=seed, bsz=2, length=9)
        preds = _perturbed(target, seed=seed + 10, share=0.5)
        jm.update(preds, target)
        pm.update(preds, target)
    _close(pm.compute(), jm.compute(), rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------------- errors

def test_missing_hash_encoder_and_model_raise(weights):
    """No model is no longer an error: the hash encoders score, as in the JAX package
    (held to it in ``tests/test_torch_text_defaults.py``)."""
    enc = _batch(seed=15)
    got = bert_score(enc, enc, device="cpu")
    want = jax_bert_score(enc, enc)
    _close(got["f1"], want["f1"])
    BERTScore(device="cpu")
    _close(infolm(enc, enc, device="cpu", max_length=16), jax_infolm(enc, enc, max_length=16), rtol=0)
    InfoLM(device="cpu")


def test_strings_without_a_tokenizer_are_refused(weights):
    with pytest.raises(ValueError, match="tokenizer"):
        BERTScore(weights_path=weights["npz"], device="cpu").update(["a small test"], ["a small test"])
    with pytest.raises(ValueError, match="tokenizer"):
        InfoLM(weights_path=weights["npz"], device="cpu").update(["a small test"], ["a small test"])


def test_out_of_vocab_special_ids_are_refused(models):
    enc = _batch(seed=16)
    with pytest.raises(ValueError, match="outside the model vocab"):
        infolm(enc, enc, model=models["mlm"], special_tokens_map={"mask_token_id": 500})
