"""The trunk metrics on the compiled update, and the trunks' own captured forwards, on the CPU.

The eleven classes that run an encoder trunk (FID, IS, KID, MiFID, LPIPS,
PPL, CLIPScore, CLIP-IQA, BERTScore, InfoLM) or SRMR's filterbanks route
their updates as the JAX package's runtime does: the same ``precompile``
report (the JAX package points at its telemetry for the cause, the port at
``_auto_disabled_reason``), the same replays per signature and the same
disabled flag after one fixed stream, by default and with
``cat_state_capacity`` where the class has list states. Here a CPU metric's
step runs eagerly, so the default route equals ``auto_compile=False`` bit for
bit; against the JAX package the values agree at the tolerances the parity
files state for each class (``test_torch_{generative,image,lpips,multimodal,
srmr,bert}.py``). :class:`CapturedForward` on CPU tensors runs the trunk
eagerly and captures nothing (``test_torch_captured_forward.py`` holds its
own rules); on the card (``chip_smoke.py``'s ``captured_trunks`` phase) it
keeps one graph per input signature.

Trunks are the seeded ``_Projection`` callables and small seeded ``.npz``
checkpoints (LPIPS squeeze, a 2-layer CLIP, a 2-layer BERT), written by the
port's converters and loaded by both packages.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.audio as JA
import torchmetrics_tpu.image as JI
import torchmetrics_tpu.multimodal as JM
import torchmetrics_tpu.text as JT
import torchmetrics_tpu_torch.audio as PA
import torchmetrics_tpu_torch.image as PI
import torchmetrics_tpu_torch.multimodal as PM
import torchmetrics_tpu_torch.text as PT
import torchmetrics_tpu_torch.wrappers as PW
from tests.test_torch_captured_forward import _Doubler
from tests.test_torch_generative import _L2Sim, _Projection, _ToyGenerator
from tests.test_torch_multimodal import EOS, Tokenizer, small_config
from torchmetrics_tpu.text._bert_encoder import BertEncoderExtractor as JaxEncoder
from torchmetrics_tpu.text._bert_encoder import BertMLMExtractor as JaxMLM
from torchmetrics_tpu_torch import _compile
from torchmetrics_tpu_torch.image._inception import init_weights_
from torchmetrics_tpu_torch.image._lpips import LPIPSExtractor, LPIPSNet
from torchmetrics_tpu_torch.multimodal._clip_encoder import ClipExtractor, _ClipModel, init_clip_weights_
from torchmetrics_tpu_torch.text._bert_encoder import BertConfig, BertEncoderExtractor, _BertWithHead, init_bert_weights_
from torchmetrics_tpu_torch.utilities.convert import (
    bert_variables_from_state_dict,
    build_on_cpu,
    clip_variables_from_state_dict,
    variables_from_state_dict,
)
from torchmetrics_tpu_torch.utilities.data import RingBuffer

fshare = importlib.import_module("torchmetrics_tpu_torch.wrappers.feature_share")

BERT_CONFIG = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position=64)
SPECIAL = {"pad_token_id": 0, "cls_token_id": 101, "sep_token_id": 102, "mask_token_id": 103}
CAPTIONS = ["a cat on a mat", "two dogs"]
# the parity files' tolerances (rtol, atol) for each class's compute()
VALUE_TOL = {
    "fid": (1e-4, 0.0), "is": (1e-6, 1e-6), "kid": (1e-4, 1e-6), "mifid": (1e-4, 0.0), "lpips": (1e-4, 0.0),
    "clip_score": (1e-5, 1e-4), "clip_iqa": (1e-5, 1e-6), "srmr": (5e-3, 0.0), "bertscore": (1e-5, 1e-5),
    "infolm": (1e-4, 1e-6), "ppl": (1e-5, 0.0),
}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    folder = tmp_path_factory.mktemp("trunks")
    paths = {}
    net = init_weights_(build_on_cpu(LPIPSNet, net_type="squeeze"), seed=4)
    with torch.no_grad():
        for name, param in net.named_parameters():
            if name.startswith("lin"):
                param.abs_()
    np.savez(folder / "lpips.npz", **variables_from_state_dict(net.state_dict()))
    cfg = small_config(EOS)
    clip = init_clip_weights_(build_on_cpu(_ClipModel, cfg), seed=5)
    np.savez(folder / "clip.npz", **clip_variables_from_state_dict(clip.state_dict(), cfg))
    bert_cfg = BertConfig(**BERT_CONFIG, with_mlm_head=True)
    bert = init_bert_weights_(build_on_cpu(_BertWithHead, bert_cfg), seed=6)
    np.savez(folder / "bert.npz", **bert_variables_from_state_dict(bert.state_dict(), bert_cfg))
    for name in ("lpips", "clip", "bert"):
        paths[name] = str(folder / f"{name}.npz")
    return paths


def _to(fw, x):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x) if fw == "jax" else torch.from_numpy(x)
    return x


def _images(seed, n=4, side=8):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, side, side)).astype(np.uint8)


def _floats(seed, shape, lo=0.0, hi=1.0):
    return (np.random.default_rng(seed).random(shape) * (hi - lo) + lo).astype(np.float32)


def _tokens(seed, bsz=3, length=12):
    rng = np.random.default_rng(seed)
    ids = np.zeros((bsz, length), np.int64)
    mask = np.zeros((bsz, length), np.int64)
    for i, n in enumerate(rng.integers(4, length + 1, bsz)):
        ids[i, :n] = rng.integers(104, BERT_CONFIG["vocab_size"], n)
        ids[i, 0], ids[i, n - 1] = SPECIAL["cls_token_id"], SPECIAL["sep_token_id"]
        mask[i, :n] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _pairs(n=3, count=4):
    out = []
    for i in range(n):
        out += [((_images(i, n=count),), {"real": True}), ((_images(10 + i, n=count),), {"real": False})]
    return out


def _make(name, fw, paths, **kw):
    """The class of ``name`` in one package: ``fw`` is ``jax`` (its default routing) or ``torch`` (on the CPU)."""
    jx = fw == "jax"
    kw = dict(kw) if jx else {"device": "cpu", **kw}
    if name == "fid":
        return (JI if jx else PI).FrechetInceptionDistance(feature=_Projection(fw), **kw)
    if name == "is":
        return (JI if jx else PI).InceptionScore(feature=_Projection(fw, d=10, scale=20.0), splits=2, **kw)
    if name == "kid":
        return (JI if jx else PI).KernelInceptionDistance(feature=_Projection(fw), subsets=3, subset_size=4, **kw)
    if name == "mifid":
        return (JI if jx else PI).MemorizationInformedFrechetInceptionDistance(feature=_Projection(fw), **kw)
    if name == "lpips":
        dtype = jnp.float32 if jx else torch.float32
        return (JI if jx else PI).LearnedPerceptualImagePatchSimilarity(
            net_type="squeeze", weights_path=paths["lpips"], compute_dtype=dtype, **kw)
    if name == "clip_score":
        return (JM if jx else PM).CLIPScore(weights_path=paths["clip"], tokenizer=Tokenizer(), **kw)
    if name == "clip_iqa":
        return (JM if jx else PM).CLIPImageQualityAssessment(weights_path=paths["clip"], tokenizer=Tokenizer(), **kw)
    if name == "srmr":
        return (JA if jx else PA).SpeechReverberationModulationEnergyRatio(8000, **kw)
    if name == "bertscore":
        if jx:
            return JT.BERTScore(model=JaxEncoder(paths["bert"]), max_length=16, **kw)
        return PT.BERTScore(weights_path=paths["bert"], max_length=16, **kw)
    if name == "infolm":
        if jx:
            return JT.InfoLM(model=JaxMLM(paths["bert"]), max_length=12, special_tokens_map=SPECIAL, **kw)
        return PT.InfoLM(weights_path=paths["bert"], max_length=12, special_tokens_map=SPECIAL, **kw)
    if name == "ppl":
        return (JI if jx else PI).PerceptualPathLength(num_samples=32, batch_size=16, epsilon=1e-2, resize=None,
                                                       sim_net=_L2Sim(), **kw)
    raise KeyError(name)


def _stream(name, fw):
    """The fixed stream of update arguments: three real/fake pairs where the class takes ``real``, else three batches."""
    if name == "fid":  # more images than features: well-conditioned covariances
        return _pairs(n=3, count=40)
    if name in ("kid", "mifid"):
        return _pairs()
    if name == "kid_real_prefix":
        return [((_images(i),), {"real": True}) for i in range(3)]
    if name == "is":
        return [((_images(i),), {}) for i in range(3)]
    if name == "lpips":
        return [((_floats(i, (2, 3, 32, 32), -1, 1), _floats(20 + i, (2, 3, 32, 32), -1, 1)), {}) for i in range(3)]
    if name == "clip_score":
        return [((_floats(i, (2, 3, 32, 32)), CAPTIONS), {}) for i in range(3)]
    if name == "clip_iqa":
        return [((_floats(i, (2, 3, 32, 32)),), {}) for i in range(3)]
    if name == "srmr":
        return [((np.random.default_rng(i).standard_normal((2, 4000)).astype(np.float32),), {}) for i in range(3)]
    if name in ("bertscore", "infolm"):
        return [((_tokens(i), _tokens(30 + i)), {}) for i in range(3)]
    if name == "ppl":
        return [((_ToyGenerator(fw),), {})]
    raise KeyError(name)


def _feed(metric, fw, name, stream=None):
    for args, kwargs in stream if stream is not None else _stream(name, fw):
        metric.update(*(_to(fw, a) for a in args), **kwargs)


# every class by default, and with a ring capacity where it has list states
ROUTING = [  # (case id, stream, class, constructor kwargs)
    ("fid", "fid", "fid", {}),
    ("is", "is", "is", {}),
    ("is_capacity", "is", "is", {"cat_state_capacity": 4}),
    ("kid", "kid", "kid", {}),
    ("kid_capacity", "kid", "kid", {"cat_state_capacity": 4}),
    ("kid_capacity_real_prefix", "kid_real_prefix", "kid", {"cat_state_capacity": 4}),
    ("mifid", "mifid", "mifid", {}),
    ("mifid_capacity", "mifid", "mifid", {"cat_state_capacity": 4}),
    ("lpips", "lpips", "lpips", {}),
    ("clip_score", "clip_score", "clip_score", {}),
    ("clip_iqa", "clip_iqa", "clip_iqa", {}),
    ("clip_iqa_capacity", "clip_iqa", "clip_iqa", {"cat_state_capacity": 4}),
    ("srmr", "srmr", "srmr", {}),
    ("bertscore", "bertscore", "bertscore", {}),
    ("infolm", "infolm", "infolm", {}),
    ("ppl", "ppl", "ppl", {}),
]


def _wording(report):
    """A precompile report without the pointer to where the cause is kept (telemetry in JAX, an attribute here)."""
    reason = report["reason"]
    return report["engaged"], reason.split(" (see ")[0] if reason else None


@pytest.mark.parametrize(("stream", "cls", "kw"), [c[1:] for c in ROUTING], ids=[c[0] for c in ROUTING])
def test_routing_matches_the_jax_runtime(npz, stream, cls, kw):
    jm, pm = _make(cls, "jax", npz, **kw), _make(cls, "torch", npz, **kw)
    jseq, pseq = _stream(stream, "jax"), _stream(stream, "torch")
    (ja, jk), (pa, pk) = jseq[0], pseq[0]
    rj = jm.precompile(*(_to("jax", a) for a in ja), **jk)
    rp = pm.precompile(*(_to("torch", a) for a in pa), **pk)
    assert _wording(rp) == _wording(rj)
    _feed(jm, "jax", stream, jseq)
    _feed(pm, "torch", stream, pseq)
    assert pm._auto_disabled == jm._auto_disabled
    if cls in ("bertscore", "infolm"):
        # numpy arguments: the JAX runtime keys the signature and fails to trace it; the port cannot key it
        assert sorted(jm._auto_sigs.values()) == [0] and pm._auto_sigs == {} and pm._auto_disabled
    else:
        assert sorted(pm._auto_sigs.values()) == sorted(jm._auto_sigs.values())
    if stream == "kid_real_prefix":  # no fake batch has shaped the fake ring yet: eager in both
        assert not rp["engaged"] and all(v == 0 for v in pm._auto_sigs.values())
    # compiled by default, or with a capacity; KID and MiFID only once both rings have taken a batch
    compiled = {"fid", "lpips", "clip_score", "srmr"} | ({"is", "kid", "mifid", "clip_iqa"} if kw else set())
    if cls in compiled and stream != "kid_real_prefix":
        assert rp == ({"engaged": True, "reason": None} if cls not in ("kid", "mifid") else
                      {"engaged": False, "reason": "update did not compile (see `_auto_disabled_reason`)"})
        assert "_auto_update_fn" in pm.__dict__ and pm._auto_disabled_reason is None
        assert all(v > 0 for v in pm._auto_sigs.values())


def _state_equal(a, b):
    if isinstance(a, RingBuffer):
        return a.count == b.count and torch.equal(a.values(), b.values())
    if isinstance(a, list):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _flat_values(value):
    if isinstance(value, dict):
        return [v for k in sorted(value) for v in _flat_values(value[k])]
    if isinstance(value, (tuple, list)):
        return [v for x in value for v in _flat_values(x)]
    return [value]


def _compute(metric, framework):
    np.random.seed(7)  # IS and KID draw their permutations from numpy's global generator in both packages
    return [np.asarray(v) if framework == "jax" else v for v in _flat_values(metric.compute())]


VALUES = [
    ("fid", "fid", {}),
    ("is_capacity", "is", {"cat_state_capacity": 64}),
    ("kid_capacity", "kid", {"cat_state_capacity": 64}),
    ("mifid_capacity", "mifid", {"cat_state_capacity": 64}),
    ("lpips", "lpips", {}),
    ("clip_score", "clip_score", {}),
    ("clip_iqa_capacity", "clip_iqa", {"cat_state_capacity": 64}),
    ("srmr", "srmr", {}),
    ("bertscore", "bertscore", {}),
    ("infolm", "infolm", {}),
    ("ppl", "ppl", {}),
]


@pytest.mark.parametrize(("cls", "kw"), [c[1:] for c in VALUES], ids=[c[0] for c in VALUES])
def test_default_route_equals_eager_and_matches_jax(npz, cls, kw):
    compiled, eager = _make(cls, "torch", npz, **kw), _make(cls, "torch", npz, auto_compile=False, **kw)
    for m in (compiled, eager):
        _feed(m, "torch", cls)
    for name in compiled._defaults:
        assert _state_equal(getattr(compiled, name), getattr(eager, name)), name
    got, want_eager = _compute(compiled, "torch"), _compute(eager, "torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want_eager))
    jm = _make(cls, "jax", npz, **kw)
    _feed(jm, "jax", cls)
    rtol, atol = VALUE_TOL[cls]
    want = _compute(jm, "jax")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------- CapturedForward


class _InlineProbe(_Projection):
    """A callable trunk that records, at each call, whether trunks run inline there."""

    def __init__(self):
        super().__init__("torch", d=4, in_dim=3 * 8 * 8)
        self.inline = []

    def __call__(self, imgs):
        self.inline.append(bool(getattr(_compile._GRAPH_WORK, "inline", 0)))
        return super().__call__(imgs)


@pytest.mark.parametrize(
    ("name", "auto", "reals", "want"),
    [
        # the first call of each signature: the next one captures, and its graph holds the trunk
        ("fid", True, (True, False, True, False), [True, True, False, False]),
        ("fid", False, (True, False, True, False), [False] * 4),
        # a real-only prefix: the ring of fake features is unshaped, so the second real call stays eager
        ("kid", True, (True, True, True), [True, False, False]),
    ],
)
def test_a_compiling_metric_runs_its_trunk_inline_on_a_signatures_first_call(name, auto, reals, want):
    probe = _InlineProbe()
    if name == "fid":
        metric = PI.FrechetInceptionDistance(feature=probe, auto_compile=auto, device="cpu")
    else:
        metric = PI.KernelInceptionDistance(feature=probe, subsets=2, subset_size=4, cat_state_capacity=16,
                                            auto_compile=auto, device="cpu")
    for i, real in enumerate(reals):
        metric.update(torch.from_numpy(_images(i, n=4)), real=real)
    assert probe.inline == want and "_auto_capture_next" not in metric.__dict__
    assert getattr(_compile._GRAPH_WORK, "inline", 0) == 0


@pytest.mark.parametrize("trunk_kind", ["inception", "lpips", "bert", "clip"])
def test_the_trunks_run_their_forward_through_one_captured_forward(npz, trunk_kind):
    """Each built-in trunk holds a CapturedForward; on CPU tensors it runs the plain forward."""
    if trunk_kind == "inception":
        trunk = PI.InceptionScore(device="cpu").inception
        x = (torch.from_numpy(_images(1, n=2, side=16)),)
    elif trunk_kind == "lpips":
        trunk = LPIPSExtractor("squeeze", weights_path=npz["lpips"], compute_dtype=torch.float32, device="cpu")
        x = tuple(torch.from_numpy(_floats(s, (2, 3, 32, 32), -1, 1)) for s in (1, 2))
    elif trunk_kind == "bert":
        trunk = BertEncoderExtractor(npz["bert"], device="cpu")
        enc = _tokens(1)
        x = (torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
    else:
        trunk = ClipExtractor(npz["clip"], device="cpu")
        x = (torch.from_numpy(_floats(1, (2, 3, 32, 32))),)
    seen = []
    original = trunk.captured.forward

    def spy(fn, *inputs, statics=()):
        seen.append(statics)
        return original(fn, *inputs, statics=statics)

    trunk.captured.forward = spy
    out = trunk.get_image_features(*x) if trunk_kind == "clip" else trunk(*x)
    assert torch.isfinite(out).all() and len(seen) == 1 and trunk.captured.graphs == {}


def test_mlm_logits_at_takes_the_position_as_an_input(npz):
    from torchmetrics_tpu_torch.text._bert_encoder import BertMLMExtractor

    mlm = BertMLMExtractor(npz["bert"], device="cpu")
    enc = _tokens(2)
    ids, mask = torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"])
    full = mlm(ids, mask)
    for index in (0, 5, -1):
        torch.testing.assert_close(mlm.logits_at(ids, mask, index), full[:, index], rtol=1e-5, atol=1e-5)
    with pytest.raises(IndexError, match="outside"):
        mlm.logits_at(ids, mask, 12)
    # every position reaches the captured forward with one signature: on the card one graph per (B, L)
    keys = set()
    original = mlm.captured.forward

    def spy(fn, *inputs, statics=()):
        keys.add((statics, tuple((tuple(x.shape), x.dtype, *_compile.layout_key(x)) for x in inputs)))
        return original(fn, *inputs, statics=statics)

    mlm.captured.forward = spy
    for index in range(-12, 12):
        mlm.logits_at(ids, mask, index)
    assert len(keys) == 1


def test_inception_score_without_capacity_keeps_distinct_feature_entries():
    metric = PI.InceptionScore(feature=_Projection("torch", d=10, scale=20.0), device="cpu")
    for i in range(3):
        metric.update(torch.from_numpy(_images(i)))
    assert metric._auto_disabled and len(metric.features) == 3
    assert len({f.data_ptr() for f in metric.features}) == 3
    assert not torch.equal(metric.features[0], metric.features[1])


@pytest.mark.parametrize("inference", [False, True])
def test_feature_share_misses_the_cache_through_a_captured_forward(inference):
    """Fault C4 through the captured trunk: a buffer refilled in place between real and fake runs the trunk for each."""
    rng = np.random.default_rng(11)
    real = [torch.from_numpy(rng.integers(0, 256, (12, 3, 4, 4)).astype(np.uint8)) for _ in range(3)]
    fake = [torch.from_numpy(rng.integers(0, 256, (12, 3, 4, 4)).astype(np.uint8)) for _ in range(3)]

    def members(trunk):
        return [PI.FrechetInceptionDistance(feature=trunk, device="cpu"),
                PI.KernelInceptionDistance(feature=trunk, subsets=3, subset_size=10, device="cpu"),
                PI.MemorizationInformedFrechetInceptionDistance(feature=trunk, device="cpu")]

    trunk = _Doubler()
    shared_members = members(trunk)
    shared = PW.FeatureShare(shared_members)
    assert isinstance(shared_members[0].inception, fshare.NetworkCache)
    with torch.inference_mode(inference):
        buf = torch.empty((12, 3, 4, 4), dtype=torch.uint8)
        for r, f in zip(real, fake):
            buf.copy_(r)
            shared.update(buf, real=True)
            buf.copy_(f)
            shared.update(buf, real=False)
        assert trunk.calls == 6
        alone = members(_Doubler())
        for r, f in zip(real, fake):
            for m in alone:
                m.update(r, real=True)
                m.update(f, real=False)
    for m, a in zip(shared_members, alone):
        np.random.seed(0)
        got = _flat_values(m.compute())
        np.random.seed(0)
        assert all(torch.equal(g, w) for g, w in zip(got, _flat_values(a.compute())))
