"""CLIPScore, CLIP-IQA and the CLIP towers on the CPU, against the JAX package.

Both packages load one seeded ``.npz``, written by the port's
``clip_variables_from_state_dict`` at the JAX equivalence suite's small
widths (``tests/unittests/multimodal/test_clip_encoder_equivalence.py``).
float32 features agree within ``RTOL``/``ATOL`` (the suite's own): the same
float32 graph, sums in another order; both EOS branches, truncation, and
resizes up and down from non-square sizes. With ``compute_dtype`` bf16 the
two round at the same places, but a float32 sum in another order can flip a
bf16 rounding, so features agree within ``BF16_ULPS`` bf16 ulps of their
scale. The default random-projection encoder, CLIPScore and CLIP-IQA
(one prompt, the keyword dict, custom pairs) within ``SCORE_RTOL`` (CLIP-IQA's
probabilities on the random projections within ``PROB_ATOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.multimodal as JF
import torchmetrics_tpu.multimodal as JM
import torchmetrics_tpu_torch.functional.multimodal as PF
import torchmetrics_tpu_torch.multimodal as PM
from torchmetrics_tpu.functional.multimodal._encoder import RandomProjectionClipEncoder as JEnc
from torchmetrics_tpu.multimodal._clip_encoder import ClipExtractor as JClip
from torchmetrics_tpu_torch.functional.multimodal._encoder import RandomProjectionClipEncoder as PEnc
from torchmetrics_tpu_torch.multimodal._clip_encoder import ClipConfig, ClipExtractor, _ClipModel, init_clip_weights_
from torchmetrics_tpu_torch.utilities.convert import (
    build_on_cpu,
    clip_state_dict_from_variables,
    clip_variables_from_state_dict,
    load_variables_npz,
)

RTOL, ATOL = 1e-4, 1e-5
BF16_ULPS = 1.0  # of 2**-8 relative to the features' largest magnitude
SCORE_RTOL = 1e-5
# CLIP-IQA on the random-projection encoder: its draws agree with JAX's within ~2 ulp, so features and cosines
# ~5e-7 apart; the softmax of 100 * cosine turns that into up to ~5e-5 of the logit gap, and p (1 - p) of it
PROB_ATOL = 3e-5
EOS = 98  # the small vocabulary's top id, as 49407 is CLIP's
TEXT = ["a cat on a mat", "two dogs", "", "A CAT on a mat"]


def small_config(eos_token_id):
    return ClipConfig(vocab_size=99, text_hidden=40, text_layers=2, text_heads=4, text_intermediate=64,
                      max_position=24, vision_hidden=48, vision_layers=2, vision_heads=4, vision_intermediate=64,
                      image_size=32, patch_size=8, projection_dim=32, eos_token_id=eos_token_id)


@pytest.fixture(scope="module", params=[EOS, 2], ids=["first_eos", "legacy_argmax"])
def npz(request, tmp_path_factory):
    cfg = small_config(request.param)
    net = init_clip_weights_(build_on_cpu(_ClipModel, cfg), seed=request.param)
    path = str(tmp_path_factory.mktemp("clip") / "clip.npz")
    np.savez(path, **clip_variables_from_state_dict(net.state_dict(), cfg))
    return path


def token_batch(seed, batch=3, length=12, width=None):
    rng = np.random.default_rng(seed)
    width = width or length
    ids = rng.integers(3, EOS, (batch, width))
    ids[:, 0] = 1
    mask = np.zeros((batch, width), np.int64)
    for i, ln in enumerate(([length, length - 3, length - 1] * batch)[:batch]):
        ids[i, ln - 1] = EOS
        ids[i, ln:] = 0
        mask[i, :ln] = 1
    return ids, mask


class Tokenizer:
    """Word ids from a stable hash, BOS 1 and EOS 98, padded to the longest sentence."""

    def __call__(self, texts):
        rows = [[1] + [3 + sum(map(ord, w)) % 90 for w in t.lower().split()] + [EOS] for t in texts]
        width = max(map(len, rows))
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, row in enumerate(rows):
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def test_npz_round_trip(npz):
    flat = load_variables_npz(npz)
    state, cfg = clip_state_dict_from_variables(flat)
    again = clip_variables_from_state_dict(state, cfg)
    assert sorted(again) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(again[key], flat[key], err_msg=key)


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (2, 3, 45, 70), (3, 3, 20, 27), (1, 3, 64, 17)],
                         ids=["native", "down", "up", "mixed"])
def test_image_features_match_jax(npz, shape):
    imgs = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = ClipExtractor(npz, device="cpu").get_image_features(torch.from_numpy(imgs))
    want = np.asarray(JClip(npz).get_image_features(jnp.asarray(imgs)))
    assert got.shape == (shape[0], 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_uint8_images_match_jax(npz):
    imgs = np.random.default_rng(5).integers(0, 256, (2, 3, 40, 36), dtype=np.uint8)
    got = ClipExtractor(npz, device="cpu").get_image_features(torch.from_numpy(imgs))
    want = np.asarray(JClip(npz).get_image_features(jnp.asarray(imgs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_text_features_match_jax_with_truncation(npz):
    port, ref = ClipExtractor(npz, device="cpu"), JClip(npz)
    ids, mask = token_batch(1)
    for enc in ({"input_ids": ids, "attention_mask": mask},
                # 30 tokens, cut to the 24 positions: the first row keeps its EOS, the others lose it
                dict(zip(("input_ids", "attention_mask"), token_batch(2, length=20, width=30)))):
        enc["input_ids"][1:, 20:] = 7  # past the EOS of rows 1 and 2: EOS gone after the cut
        enc["attention_mask"][1:, :] = 1
        got = port.get_text_features(enc)
        want = np.asarray(ref.get_text_features(enc))
        assert got.shape == (3, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fully_padded_row_matches_jax(npz):
    ids, mask = token_batch(3)
    mask[2] = 0  # a row with no token attended: the -1e9 biases, not -inf, keep it finite
    got = ClipExtractor(npz, device="cpu").get_text_features({"input_ids": ids, "attention_mask": mask})
    want = np.asarray(JClip(npz).get_text_features({"input_ids": ids, "attention_mask": mask}))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bf16_compute_matches_jax(npz):
    port = ClipExtractor(npz, device="cpu", compute_dtype=torch.bfloat16)
    ref = JClip(npz, compute_dtype=jnp.bfloat16)
    imgs = np.random.default_rng(9).random((2, 3, 45, 70)).astype(np.float32)
    ids, mask = token_batch(4)
    for got, want in ((port.get_image_features(torch.from_numpy(imgs)), ref.get_image_features(jnp.asarray(imgs))),
                      (port.get_text_features({"input_ids": ids, "attention_mask": mask}),
                       ref.get_text_features({"input_ids": ids, "attention_mask": mask}))):
        want = np.asarray(want)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= BF16_ULPS * 2.0**-8 * np.abs(want).max()


def test_tokenizer_and_its_absence(npz):
    port = ClipExtractor(npz, tokenizer=Tokenizer(), device="cpu")
    got = port.get_text_features(TEXT)
    want = np.asarray(JClip(npz, tokenizer=Tokenizer()).get_text_features(TEXT))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(port.get_text_features("a cat"), port.get_text_features(["a cat"]))
    with pytest.raises(ValueError, match="tokenizer"):
        ClipExtractor(npz, device="cpu").get_text_features(["a photo of a cat"])


def test_clip_score_and_iqa_classes_on_converted_weights(npz):
    rng = np.random.default_rng(11)
    imgs = rng.random((4, 3, 40, 48)).astype(np.float32)
    port = PM.CLIPScore(weights_path=npz, tokenizer=Tokenizer(), device="cpu")
    ref = JM.CLIPScore(weights_path=npz, tokenizer=Tokenizer(), auto_compile=False)
    assert PM.CLIPScore.full_state_update is True
    got_b = port(list(torch.from_numpy(imgs[:2])), TEXT[:2])
    want_b = ref(list(jnp.asarray(imgs[:2])), TEXT[:2])
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=SCORE_RTOL, atol=1e-4)
    port.update(torch.from_numpy(imgs[2:]), TEXT[2:])
    ref.update(jnp.asarray(imgs[2:]), TEXT[2:])
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=SCORE_RTOL, atol=1e-4)
    assert int(port.n_samples) == 4

    prompts = ("quality", ("Sharp photo.", "Blurry photo."))
    iqa = PM.CLIPImageQualityAssessment(weights_path=npz, tokenizer=Tokenizer(), prompts=prompts, device="cpu")
    jiqa = JM.CLIPImageQualityAssessment(weights_path=npz, tokenizer=Tokenizer(), prompts=prompts, auto_compile=False)
    assert iqa.anchors.device == torch.device("cpu") and iqa.anchors.shape == (4, 32)
    for lo, hi in ((0, 3), (3, 4)):
        iqa.update(torch.from_numpy(imgs[lo:hi]))
        jiqa.update(jnp.asarray(imgs[lo:hi]))
    got, want = iqa.compute(), jiqa.compute()
    assert sorted(got) == sorted(want) == ["quality", "user_defined_0"]
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=SCORE_RTOL, atol=1e-6)


def test_random_projection_encoder_matches_jax():
    with pytest.warns(UserWarning, match="random projections"):
        port = PEnc(device="cpu")
    ref = JEnc(warn=False)
    np.testing.assert_allclose(port._proj.numpy(), np.asarray(ref._proj), rtol=0, atol=1e-6)
    for shape in [(2, 3, 64, 64), (1, 3, 37, 90), (2, 3, 5, 7)]:
        imgs = np.random.default_rng(shape[2]).random(shape).astype(np.float32) * 3 - 1
        got = port.get_image_features(torch.from_numpy(imgs))
        want = np.asarray(ref.get_image_features(jnp.asarray(imgs)))
        np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_RTOL, atol=1e-6)
    got = port.get_text_features(TEXT)
    want = np.asarray(ref.get_text_features(TEXT))
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_RTOL, atol=1e-6)
    assert torch.equal(got[0], got[3])  # lower-cased tokens


def test_functional_clip_score_default_encoder_matches_jax():
    imgs = np.random.default_rng(1).random((3, 3, 48, 48)).astype(np.float32)
    got = PF.clip_score(torch.from_numpy(imgs), TEXT[:3])
    want = JF.clip_score(jnp.asarray(imgs), TEXT[:3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_RTOL, atol=1e-5)
    one = PF.clip_score(torch.from_numpy(imgs[0]), "a cat on a mat")
    np.testing.assert_allclose(one.numpy(), np.asarray(JF.clip_score(jnp.asarray(imgs[0]), "a cat on a mat")),
                               rtol=SCORE_RTOL, atol=1e-5)
    assert float(got) >= 0.0
    with pytest.raises(ValueError, match="number of images and text"):
        PF.clip_score(torch.from_numpy(imgs), TEXT[:2])
    with pytest.raises(ValueError, match="3d"):
        PF.clip_score([torch.zeros(3, 8, 8), torch.zeros(8, 8)], TEXT[:2])


@pytest.mark.parametrize(
    "prompts", [("quality",), ("brightness", "noisiness", "warm"), (("Nice.", "Awful."), "real"), (("A.", "B."),)],
    ids=["one", "dict", "custom_and_keyword", "one_custom"],
)
def test_functional_clip_iqa_matches_jax(prompts):
    imgs = np.random.default_rng(len(prompts)).random((3, 3, 40, 40)).astype(np.float32) * 255
    got = PF.clip_image_quality_assessment(torch.from_numpy(imgs), data_range=255.0, prompts=prompts)
    want = JF.clip_image_quality_assessment(jnp.asarray(imgs), data_range=255.0, prompts=prompts)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=SCORE_RTOL, atol=PROB_ATOL)
    else:
        assert got.shape == np.asarray(want).shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCORE_RTOL, atol=PROB_ATOL)


def test_clip_iqa_class_default_encoder_matches_jax():
    imgs = np.random.default_rng(2).random((4, 3, 32, 32)).astype(np.float32)
    port = PM.CLIPImageQualityAssessment(prompts=("quality", "happy"), device="cpu")
    ref = JM.CLIPImageQualityAssessment(prompts=("quality", "happy"), auto_compile=False)
    for lo, hi in ((0, 1), (1, 4)):
        port.update(torch.from_numpy(imgs[lo:hi]))
        ref.update(jnp.asarray(imgs[lo:hi]))
    got, want = port.compute(), ref.compute()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=SCORE_RTOL, atol=PROB_ATOL)
    single = PM.CLIPImageQualityAssessment(device="cpu")
    single.update(torch.from_numpy(imgs))
    assert single.compute().shape == (4,)


def test_prompt_validation_errors():
    for prompts, match in [(["quality"], "must be a tuple"), ((3,), "must be a tuple"),
                           (("nope",), "must be one of"), ((("a", "b", "c"),), "length 2")]:
        with pytest.raises(ValueError, match=match):
            PF.clip_image_quality_assessment(torch.rand(1, 3, 16, 16), prompts=prompts)
        with pytest.raises(ValueError, match=match):
            JF.clip_image_quality_assessment(jnp.zeros((1, 3, 16, 16)), prompts=prompts)


def test_multimodal_classes_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.CLIPScore()
    with pytest.raises(RuntimeError, match="CUDA"):
        PEnc(warn=False)
