"""The port's C RLE codec (``csrc/rle.c``, built with the system C compiler) against its pure-Python plain version and the JAX package's codec.

Random masks of several sizes and densities, an empty mask, a full mask and
a 0x0 mask round-trip through both codecs with identical counts, strings and
masks. The port's codec must come from its own ``_build/`` directory, never
from the JAX package's ``.native_cache/``.
"""

import numpy as np
import pytest

import torchmetrics_tpu.functional.detection._rle as jax_rle
import torchmetrics_tpu_torch.functional.detection._rle as rle
from torchmetrics_tpu_torch.utilities import nvcc


def _masks():
    rng = np.random.default_rng(0)
    out = [np.zeros((7, 5), np.uint8), np.ones((4, 9), np.uint8), np.zeros((0, 0), np.uint8)]
    for _ in range(12):
        h, w = rng.integers(1, 48, 2)
        out.append((rng.random((h, w)) > rng.random()).astype(np.uint8))
    blob = np.zeros((427, 640), np.uint8)
    blob[100:300, 50:400] = 255  # nonzero is foreground
    return [*out, blob]


@pytest.mark.parametrize("index", range(16))
def test_codec_matches_plain_and_jax(index):
    mask = _masks()[index]
    counts = rle.mask_to_rle_counts(mask)
    assert counts == rle.mask_to_rle_counts_plain(mask) == jax_rle.mask_to_rle_counts(mask)
    assert sum(counts) == mask.size
    string = rle.rle_string_encode(counts)
    assert string == rle.rle_string_encode_plain(counts) == jax_rle.rle_string_encode(counts)
    assert rle.rle_string_decode(string) == rle.rle_string_decode_plain(string) == counts
    size = list(mask.shape)
    decoded = rle.rle_counts_to_mask(counts, size)
    np.testing.assert_array_equal(decoded, rle.rle_counts_to_mask_plain(counts, size))
    np.testing.assert_array_equal(decoded, (mask != 0).astype(np.uint8))
    np.testing.assert_array_equal(rle.ann_to_mask({"counts": string, "size": size}, *size), decoded)


def test_known_counts_and_corrupt_strings():
    assert rle.mask_to_rle_counts(np.array([[0, 1, 1, 1, 0, 0, 0, 0, 0]], np.uint8)) == [1, 3, 5]
    assert rle.mask_to_rle_counts(np.array([[1, 1, 0]], np.uint8)) == [0, 2, 1]
    for bad, match in ((b"0" + bytes([48 + 0x20]), "truncated"), (bytes([48 + 0x20]) * 14 + b"0", "overlong")):
        for decode in (rle.rle_string_decode, rle.rle_string_decode_plain):
            with pytest.raises(ValueError, match=match):
                decode(bad)


def test_codec_is_built_from_the_ports_own_source():
    lib = rle._library()
    assert rle.SOURCE == nvcc.CSRC_DIR / "rle.c" and rle.SOURCE.exists()
    assert str(nvcc.BUILD_DIR) in lib._name and ".native_cache" not in lib._name
    assert "torchmetrics_tpu/" not in lib._name.replace("torchmetrics_tpu_torch/", "")
