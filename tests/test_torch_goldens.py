"""The classification and detection golden cases replayed through the port's functionals.

``tests/goldens/goldens.npz`` holds values frozen from the original
torchmetrics over the seeded inputs of ``tests/helpers/golden_specs.py``.
Replaying the stat-scores/accuracy/confusion-matrix cases and those of the
precision/recall/F-beta/F1, precision-recall curve, ROC and AUROC families,
and the 43 of the rest of classification (MCC, kappa, Jaccard, specificity,
Hamming, exact match, Dice, average precision, the four operating points,
calibration, hinge, ranking and fairness), through ``torchmetrics_tpu_torch`` holds the port to torchmetrics itself, not
only to the JAX package, at each spec's own ``atol`` (and ``rtol=1e-4``, as the
JAX package's replay in ``tests/unittests/test_goldens.py``). A curve's output
is several leaves (``/0`` .. ``/k`` in the pack: precision, recall and
thresholds, per class for the multiclass and multilabel curves; a dict's
values in key order), flattened in the order the JAX replay flattens them. The six detection cases (158-163: the
IoU family, frozen from the JAX package because the reference delegates to
torchvision, and the two panoptic qualities, frozen from torchmetrics) replay
the same way. The 14 text cases without a model (164-177: the edit family,
TER, EED, BLEU, SacreBLEU, chrF, ROUGE, perplexity, SQuAD) run the string
functionals with ``device="cpu"``. The 16 image cases without a network
(126-141: PSNR, PSNR-B, SSIM, MS-SSIM, UQI, SAM, ERGAS, RASE, RMSE-SW, TV,
SCC, VIF, D_lambda, image gradients, D_s, QNR) replay on CPU tensors, and so
do the 19 regression cases (070, 075-092), the five pairwise ones (143-147),
the ten of retrieval (148-157), the 16 of clustering (093-108), the
nine of nominal association (109-117) and the eight of audio (118-125: the
SNR family, SDR and PIT frozen from torchmetrics, SRMR from the JAX
package). ``NOT_REPLAYED`` lists the cases left: the three trunks with
random weights that the JAX suite skips as well.
"""

import json
import os

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as TF

from tests.helpers.golden_specs import SPECS

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
PORTED = [
    f"{task}_{name}"
    for task in ("binary", "multiclass", "multilabel")
    for name in ("accuracy", "confusion_matrix", "stat_scores")
]
SLICE = [
    f"{task}_{name}"
    for task in ("binary", "multiclass", "multilabel")
    for name in ("precision", "recall", "fbeta_score", "f1_score", "precision_recall_curve", "roc", "auroc")
]
CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in PORTED + SLICE]
# detection (cases 158-163): the IoU family's values were frozen from the JAX package ("self"), since the
# reference delegates to torchvision; the two panoptic qualities' from torchmetrics ("ref")
DETECTION = {
    "intersection_over_union": "self", "generalized_intersection_over_union": "self",
    "distance_intersection_over_union": "self", "complete_intersection_over_union": "self",
    "panoptic_quality": "ref", "modified_panoptic_quality": "ref",
}
DETECTION_CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in DETECTION]
# the rest of classification: MCC, kappa, Jaccard, specificity, Hamming, exact match, Dice, average precision,
# the operating points, calibration, hinge, ranking and fairness (070, critical_success_index, is regression)
REST = [
    "binary_average_precision", "binary_calibration_error", "binary_cohen_kappa", "binary_hamming_distance",
    "binary_hinge_loss", "binary_jaccard_index", "binary_matthews_corrcoef", "binary_specificity",
    "binary_precision_at_fixed_recall", "binary_recall_at_fixed_precision", "binary_sensitivity_at_specificity",
    "binary_specificity_at_sensitivity", "multiclass_average_precision", "multiclass_calibration_error",
    "multiclass_cohen_kappa", "multiclass_exact_match", "multiclass_hamming_distance", "multiclass_hinge_loss",
    "multiclass_jaccard_index", "multiclass_matthews_corrcoef", "multiclass_specificity",
    "multiclass_precision_at_fixed_recall", "multiclass_recall_at_fixed_precision",
    "multiclass_sensitivity_at_specificity", "multiclass_specificity_at_sensitivity", "multilabel_average_precision",
    "multilabel_coverage_error", "multilabel_exact_match", "multilabel_hamming_distance", "multilabel_jaccard_index",
    "multilabel_matthews_corrcoef", "multilabel_specificity", "multilabel_ranking_average_precision",
    "multilabel_ranking_loss", "multilabel_precision_at_fixed_recall", "multilabel_recall_at_fixed_precision",
    "multilabel_sensitivity_at_specificity", "multilabel_specificity_at_sensitivity", "dice", "binary_fairness",
    "binary_groups_stat_rates", "demographic_parity", "equal_opportunity",
]
REST_CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in REST]
REST_IDS = ["002", "003", "004", "007", "008", "009", "010", "013", "018", "019", "020", "021", "025", "026", "027",
            "029", "031", "032", "033", "034", "037", "042", "043", "044", "045", "048", "050", "051", "053", "054",
            "055", "058", "062", "063", "065", "066", "067", "068", "069", "071", "072", "073", "074"]
SLICE_IDS = ["001", "006", "011", "012", "015", "016", "017", "022", "024", "030", "035", "036", "039", "040", "041",
             "047", "052", "056", "057", "060", "061", "064"]


# the text metrics without a model (cases 164-177), all frozen from torchmetrics
TEXT = [
    "char_error_rate", "word_error_rate", "match_error_rate", "word_information_lost", "word_information_preserved",
    "translation_edit_rate", "extended_edit_distance", "edit_distance", "bleu_score", "sacre_bleu_score",
    "chrf_score", "rouge_score", "perplexity", "squad",
]
TEXT_CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in TEXT]
TEXT_IDS = [f"{i:03d}" for i in range(164, 178)]


# the image metrics without a network (cases 126-141), all frozen from torchmetrics
IMAGE = [
    "peak_signal_noise_ratio", "peak_signal_noise_ratio_with_blocked_effect", "structural_similarity_index_measure",
    "multiscale_structural_similarity_index_measure", "universal_image_quality_index", "spectral_angle_mapper",
    "error_relative_global_dimensionless_synthesis", "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window", "total_variation", "spatial_correlation_coefficient",
    "visual_information_fidelity", "spectral_distortion_index", "image_gradients", "spatial_distortion_index",
    "quality_with_no_reference",
]
IMAGE_CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if spec.fn in IMAGE]
IMAGE_IDS = [f"{i:03d}" for i in range(126, 142)]


# regression (070, 075-092), pairwise (143-147) and retrieval (148-157), all frozen from torchmetrics
REGRESSION_RETRIEVAL_IDS = ["070", *(f"{i:03d}" for i in range(75, 93)), *(f"{i:03d}" for i in range(143, 158))]
REGRESSION_RETRIEVAL_CASES = [
    (f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if f"{idx:03d}" in REGRESSION_RETRIEVAL_IDS
]
# clustering (093-108) and nominal association (109-117), all frozen from torchmetrics
CLUSTERING_NOMINAL_IDS = [f"{i:03d}" for i in range(93, 118)]
CLUSTERING_NOMINAL_CASES = [
    (f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if f"{idx:03d}" in CLUSTERING_NOMINAL_IDS
]
# audio (118-125): the SNR family, SDR and PIT frozen from torchmetrics ("ref"), SRMR from the JAX package ("self")
AUDIO_IDS = [f"{i:03d}" for i in range(118, 126)]
AUDIO_CASES = [(f"{idx:03d}_{spec.fn}", spec) for idx, spec in enumerate(SPECS) if f"{idx:03d}" in AUDIO_IDS]
# LPIPS, BERTScore and InfoLM (142, 178, 179: random trunk weights, skipped by the JAX suite too)
NOT_REPLAYED = ["142", "178", "179"]


def test_every_case_is_replayed_or_listed_as_not_replayed():
    replayed = [case_id[:3] for case_id, _ in CASES + REST_CASES + DETECTION_CASES + TEXT_CASES + IMAGE_CASES
                + REGRESSION_RETRIEVAL_CASES + CLUSTERING_NOMINAL_CASES + AUDIO_CASES]
    assert len(replayed) == len(set(replayed)) == 177
    assert sorted(replayed + NOT_REPLAYED) == [f"{i:03d}" for i in range(len(SPECS))] and len(SPECS) == 180


def test_all_nine_cases_are_in_the_pack():
    assert sorted(spec.fn for _, spec in CASES if spec.fn in PORTED) == sorted(PORTED)


def test_the_22_cases_of_the_slice_are_in_the_pack():
    assert sorted(case_id[:3] for case_id, spec in CASES if spec.fn in SLICE) == SLICE_IDS


def test_the_43_cases_of_the_rest_of_classification_are_in_the_pack():
    assert [case_id[:3] for case_id, _ in REST_CASES] == REST_IDS


def _flatten_output(out) -> list:
    if isinstance(out, dict):  # in key order, as the JAX replay flattens a dict
        return [leaf for key in sorted(out) for leaf in _flatten_output(out[key])]
    if isinstance(out, (list, tuple)):
        return [leaf for item in out for leaf in _flatten_output(item)]
    return [out]


@pytest.mark.parametrize(("case_id", "spec"), CASES + REST_CASES, ids=[c[0] for c in CASES + REST_CASES])
def test_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref"
    leaves = _flatten_output(getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **spec.kwargs))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        assert leaf.shape == golden.shape, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
            err_msg=f"{case_id} leaf {li}",
        )


def test_the_six_detection_cases_are_in_the_pack():
    assert [case_id for case_id, _ in DETECTION_CASES] == [
        "158_intersection_over_union", "159_generalized_intersection_over_union",
        "160_distance_intersection_over_union", "161_complete_intersection_over_union",
        "162_panoptic_quality", "163_modified_panoptic_quality",
    ]


@pytest.mark.parametrize(("case_id", "spec"), DETECTION_CASES, ids=[c[0] for c in DETECTION_CASES])
def test_detection_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == DETECTION[spec.fn] and meta["n_leaves"] == 1
    got = getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **spec.kwargs)
    golden = pack[f"{case_id}/0"]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
                               err_msg=case_id)


def test_the_14_text_cases_are_in_the_pack():
    assert [case_id[:3] for case_id, _ in TEXT_CASES] == TEXT_IDS


def _text_args(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize(("case_id", "spec"), TEXT_CASES, ids=[c[0] for c in TEXT_CASES])
def test_text_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref"
    device = {} if spec.fn == "perplexity" else {"device": "cpu"}
    leaves = _flatten_output(getattr(TF, spec.fn)(*_text_args(spec.make()), **spec.kwargs, **device))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        assert leaf.shape == golden.shape, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
            err_msg=f"{case_id} leaf {li}",
        )


def test_the_16_image_cases_are_in_the_pack():
    assert [case_id[:3] for case_id, _ in IMAGE_CASES] == IMAGE_IDS


@pytest.mark.parametrize(("case_id", "spec"), IMAGE_CASES, ids=[c[0] for c in IMAGE_CASES])
def test_image_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref"
    leaves = _flatten_output(getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **spec.kwargs))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        assert leaf.shape == golden.shape, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
            err_msg=f"{case_id} leaf {li}",
        )


def test_the_34_regression_pairwise_and_retrieval_cases_are_in_the_pack():
    assert [case_id[:3] for case_id, _ in REGRESSION_RETRIEVAL_CASES] == REGRESSION_RETRIEVAL_IDS
    assert len(REGRESSION_RETRIEVAL_IDS) == 34


@pytest.mark.parametrize(("case_id", "spec"), REGRESSION_RETRIEVAL_CASES, ids=[c[0] for c in REGRESSION_RETRIEVAL_CASES])
def test_regression_and_retrieval_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref"
    leaves = _flatten_output(getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **spec.kwargs))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        # as the JAX replay compares: by value, broadcast; torchmetrics froze concordance (083) as shape (1,),
        # where both packages give a 0-d value
        assert leaf.numel() == golden.size, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4, equal_nan=True,
            err_msg=f"{case_id} leaf {li}",
        )


def test_the_25_clustering_and_nominal_cases_are_in_the_pack():
    assert [case_id[:3] for case_id, _ in CLUSTERING_NOMINAL_CASES] == CLUSTERING_NOMINAL_IDS
    assert len(CLUSTERING_NOMINAL_IDS) == 25


@pytest.mark.parametrize(("case_id", "spec"), CLUSTERING_NOMINAL_CASES, ids=[c[0] for c in CLUSTERING_NOMINAL_CASES])
def test_clustering_and_nominal_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == "ref"
    # the generalized mean's power (108) is a number, not an array
    leaves = _flatten_output(getattr(TF, spec.fn)(*_text_args(spec.make()), **spec.kwargs))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        assert leaf.shape == golden.shape, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
            err_msg=f"{case_id} leaf {li}",
        )


def test_the_8_audio_cases_are_in_the_pack():
    assert [case_id[:3] for case_id, _ in AUDIO_CASES] == AUDIO_IDS


@pytest.mark.parametrize(("case_id", "spec"), AUDIO_CASES, ids=[c[0] for c in AUDIO_CASES])
def test_audio_golden(case_id, spec):
    pack = np.load(os.path.join(GOLDEN_DIR, "goldens.npz"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as fh:
        meta = {case["id"]: case for case in json.load(fh)["cases"]}[case_id]
    assert meta["source"] == ("self" if spec.fn == "speech_reverberation_modulation_energy_ratio" else "ref")
    kwargs = dict(spec.kwargs)
    metric_func = kwargs.pop("__metric_func", None)  # PIT's metric, by its functional name
    if metric_func:
        kwargs["metric_func"] = getattr(TF, metric_func)
    leaves = _flatten_output(getattr(TF, spec.fn)(*[torch.from_numpy(a) for a in spec.make()], **kwargs))
    assert len(leaves) == meta["n_leaves"], f"{case_id}: output arity"
    for li, leaf in enumerate(leaves):
        golden = pack[f"{case_id}/{li}"]
        assert leaf.shape == golden.shape, f"{case_id} leaf {li}"
        np.testing.assert_allclose(
            leaf.numpy().astype(np.float64), golden.astype(np.float64), atol=spec.atol, rtol=1e-4,
            err_msg=f"{case_id} leaf {li}",
        )
