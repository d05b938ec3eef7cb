"""The port's ROUGE on the CPU, against the JAX package, and a two-process sync of the text states.

LCS lengths are equal on both dispatch routes (the batched loop and the
numpy DP) and to the JAX package's; the rule-based sentence splitter replays
the JAX suite's punkt battery and agrees with the JAX splitter on seeded
CNN/DailyMail-like text; every ROUGE score is within 1e-6 (host float64 means
in the functional, float32 means of the ``cat`` states in the class). A
two-process gloo run syncs one ``sum``-state metric (WER) and one
``cat``-state metric (ROUGE) and must equal one process over all the data.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as JF
import torchmetrics_tpu.functional.text.helper as jhelper
import torchmetrics_tpu.functional.text.rouge as jrouge
import torchmetrics_tpu.text as JT
import torchmetrics_tpu_torch.functional.text as PF
import torchmetrics_tpu_torch.functional.text.helper as phelper
import torchmetrics_tpu_torch.functional.text.rouge as prouge
import torchmetrics_tpu_torch.text as PT
from tests.unittests.text.test_rouge_sentence_split import PUNKT_CASES

RTOL = 1e-6
ROUTES = {"host": 10**12, "device": 0}
KEYS = ("rouge1", "rouge2", "rouge3", "rougeL", "rougeLsum")
VOCAB = ["the", "a", "of", "to", "in", "said", "police", "he", "she", "was", "Mr.", "Dr.", "U.S.", "e.g.", "J.",
         "officials", "on", "Monday", "government", "year", "new", "people", "after", "it", "3.5", "million",
         "(CNN)", "\"quoted\"", "but", "also"]


def _doc(rng, sentences):
    out = []
    for _ in range(sentences):
        words = [VOCAB[int(rng.integers(0, len(VOCAB)))] for _ in range(int(rng.integers(4, 18)))]
        words[0] = words[0].capitalize()
        out.append(" ".join(words) + str(rng.choice([".", "!", "?", ".\"", "."])))
    return " ".join(out)


def _corpus(seed, n, refs=1):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n):
        ref = [_doc(rng, int(rng.integers(1, 5))) for _ in range(refs)]
        words = ref[0].split()
        pred = [w if rng.random() > 0.4 else VOCAB[int(rng.integers(0, len(VOCAB)))] for w in words]
        preds.append(" ".join(pred[: max(1, len(pred) - int(rng.integers(0, 6)))]))
        target.append(ref)
    return preds, target


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    monkeypatch.setattr(phelper, "_HOST_DISPATCH_MAX_CELLS", ROUTES[request.param])
    monkeypatch.setattr(jhelper, "_HOST_DISPATCH_MAX_CELLS", ROUTES[request.param])
    return request.param


@pytest.mark.parametrize(("text", "expected"), PUNKT_CASES)
def test_punkt_battery(text, expected):
    assert prouge._split_sentence(text) == expected


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitter_equals_jax_on_seeded_documents(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        doc = _doc(rng, int(rng.integers(1, 7)))
        if rng.random() < 0.3:
            doc = doc.replace(". ", ".\n", 1)
        assert prouge._split_sentence(doc) == jrouge._split_sentence(doc)


@pytest.mark.parametrize("seed", [0, 1])
def test_lcs_routes_equal_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    preds = [[str(x) for x in rng.integers(0, 6, int(rng.integers(0, 25)))] for _ in range(30)]
    tgts = [[str(x) for x in rng.integers(0, 6, int(rng.integers(0, 25)))] for _ in range(30)]
    monkeypatch.setattr(jhelper, "_HOST_DISPATCH_MAX_CELLS", 0)
    want = np.asarray(jhelper._lcs_tokens(preds, tgts))
    for limit in ROUTES.values():
        monkeypatch.setattr(phelper, "_HOST_DISPATCH_MAX_CELLS", limit)
        got = phelper._lcs_tokens(preds, tgts, device="cpu")
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    members = prouge._lcs_members(preds, tgts)  # every (prediction, target) pair in one batch
    for t, per_pred in zip(tgts, members):
        assert per_pred == [jrouge._lcs_member_indices(p, t) for p in preds]
        assert [t[i] for i in sorted(set().union(*per_pred))] == jrouge._union_lcs(preds, t)
    assert [len(members[k][k]) for k in range(len(preds))] == want.tolist()


def test_lcs_lattices_in_chunks_equal_one_batch(monkeypatch):
    rng = np.random.default_rng(3)
    preds = [[str(x) for x in rng.integers(0, 4, int(rng.integers(0, 12)))] for _ in range(7)]
    tgts = [[str(x) for x in rng.integers(0, 4, int(rng.integers(0, 12)))] for _ in range(9)]
    whole = prouge._lcs_members(preds, tgts)
    monkeypatch.setattr(prouge, "_LATTICE_CELLS", 1)  # one target sentence a chunk
    assert prouge._lcs_members(preds, tgts) == whole


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("refs", [1, 2])
def test_rouge_functional(accumulate, refs, route):
    preds, target = _corpus(10 + refs, 20, refs)
    got = PF.rouge_score(preds, target, accumulate=accumulate, rouge_keys=KEYS, device="cpu")
    want = JF.rouge_score(preds, target, accumulate=accumulate, rouge_keys=KEYS)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, err_msg=key)


def test_rouge_custom_normalizer_tokenizer_and_single_strings():
    preds, target = _corpus(3, 6)
    norm, tok = (lambda s: s.upper()), (lambda s: s.split("E"))
    got = PF.rouge_score(preds, [t[0] for t in target], normalizer=norm, tokenizer=tok, device="cpu")
    want = JF.rouge_score(preds, [t[0] for t in target], normalizer=norm, tokenizer=tok)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, err_msg=key)
    one = PF.rouge_score("My name is John", "Is your name John", rouge_keys="rouge1", device="cpu")
    assert round(float(one["rouge1_fmeasure"]), 4) == 0.75


def test_rouge_class_equals_functional_and_jax_states(route):
    preds, target = _corpus(20, 26)
    pm, jm = PT.ROUGEScore(rouge_keys=KEYS, device="cpu"), JT.ROUGEScore(rouge_keys=KEYS)
    for i, lo in enumerate(range(0, 26, 7)):
        p, t = preds[lo:lo + 7], target[lo:lo + 7]
        if i % 2:
            pm.update(p, t)
        else:
            batch = pm(p, t)
            for key, value in PF.rouge_score(p, t, rouge_keys=KEYS, device="cpu").items():
                np.testing.assert_allclose(batch[key].numpy(), value.numpy(), rtol=RTOL)
        jm.update(p, t)
    for name in pm._defaults:
        np.testing.assert_allclose(torch.cat(getattr(pm, name)).numpy(),
                                   np.concatenate([np.asarray(x) for x in getattr(jm, name)]), rtol=RTOL)
    got, want = pm.compute(), jm.compute()
    whole = PF.rouge_score(preds, target, rouge_keys=KEYS, device="cpu")
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), whole[key].numpy(), rtol=RTOL, err_msg=key)


def test_rouge_compute_of_nothing_and_validation():
    with pytest.warns(UserWarning, match="before the ``update``"):
        out = PT.ROUGEScore(rouge_keys="rougeL", device="cpu").compute()
    assert {k: float(v) for k, v in out.items()} == {"rougeL_fmeasure": 0.0, "rougeL_precision": 0.0,
                                                     "rougeL_recall": 0.0}
    with pytest.raises(ValueError, match="use_stemmer"):
        PT.ROUGEScore(use_stemmer=True, device="cpu")
    with pytest.raises(ValueError, match="rouge key"):
        PF.rouge_score("a", "a", rouge_keys="rouge10", device="cpu")
    with pytest.raises(ValueError, match="accumulate"):
        PT.ROUGEScore(accumulate="max", device="cpu")


_GLOO_WORKER = r"""
import json, sys
import torch.distributed as dist
from tests.test_torch_rouge import _corpus
import torchmetrics_tpu_torch.text as PT
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
try:
    preds, target = _corpus(70 + rank, 9 + 4 * rank)  # uneven per-rank sizes
    wer = PT.WordErrorRate(device="cpu")
    rouge = PT.ROUGEScore(rouge_keys=("rouge1", "rougeL", "rougeLsum"), device="cpu")
    wer.update(preds, [t[0] for t in target])
    rouge.update(preds, target)
    local = float(wer.errors)
    out = {"wer": float(wer.compute()), "rouge": {k: float(v) for k, v in rouge.compute().items()},
           "local_errors_restored": float(wer.errors) == local,
           "local_rows_restored": len(rouge.rouge1_fmeasure) == 1 and rouge.rouge1_fmeasure[0].numel() == len(preds)}
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def test_two_process_gloo_sync_of_wer_and_rouge():
    """Each rank's ``compute`` equals one process over both ranks' data; ``unsync`` restores the local states."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(rank), "2", str(port)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    parts = [_corpus(70 + rank, 9 + 4 * rank) for rank in range(2)]
    preds = parts[0][0] + parts[1][0]
    target = parts[0][1] + parts[1][1]
    want_wer = float(PF.word_error_rate(preds, [t[0] for t in target], device="cpu"))
    single = PT.ROUGEScore(rouge_keys=("rouge1", "rougeL", "rougeLsum"), device="cpu")
    single.update(preds, target)
    want_rouge = {k: float(v) for k, v in single.compute().items()}
    for out in outs:
        assert out["local_errors_restored"] and out["local_rows_restored"]
        np.testing.assert_allclose(out["wer"], want_wer, rtol=RTOL)
        for key, value in want_rouge.items():
            np.testing.assert_allclose(out["rouge"][key], value, rtol=RTOL, err_msg=key)
