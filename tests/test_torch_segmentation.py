"""The segmentation utilities on the CPU, against the JAX package and scipy.

Erosion, edges and neighbour codes are exact (integer counts of exact
powers of two, computed in full float32). Distances are exact minima in
float32 on both sides (the port's row-wise search gives the numbers of the
JAX package's all-pairs one); they are held within ``DIST_RTOL`` (and are
in fact equal), for both engines, every metric and with sampling. The
search is also run with ``_TILE_BYTES`` patched small, so that a mask needs
many tiles, and against ``scipy.ndimage`` directly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import torchmetrics_tpu.functional.segmentation as J
import torchmetrics_tpu_torch.functional.segmentation as P

utils = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.utils")
DIST_RTOL = 1e-5


def blobs(seed, shape, share=0.4):
    """Binary masks of smoothed noise: contiguous regions, as segmentations are."""
    rng = np.random.default_rng(seed)
    field = ndimage.uniform_filter(rng.random(shape), size=3)
    return field > np.quantile(field, 1 - share)


@pytest.mark.parametrize(("rank", "connectivity"), [(0, 1), (1, 1), (2, 1), (2, 2), (3, 1), (3, 3), (2, 0)])
def test_generate_binary_structure(rank, connectivity):
    got = P.generate_binary_structure(rank, connectivity, device="cpu")
    want = np.asarray(J.generate_binary_structure(rank, connectivity))
    np.testing.assert_array_equal(got.numpy(), want)
    if rank >= 1:
        np.testing.assert_array_equal(got.numpy(), ndimage.generate_binary_structure(rank, max(connectivity, 1)))


@pytest.mark.parametrize("shape", [(2, 3, 12, 15), (1, 2, 7, 8, 9)])
@pytest.mark.parametrize("border_value", [0, 1])
def test_binary_erosion_matches_jax_and_scipy(shape, border_value):
    image = blobs(sum(shape), shape, 0.6).astype(np.float32)
    got = P.binary_erosion(torch.from_numpy(image), border_value=border_value)
    want = np.asarray(J.binary_erosion(jnp.asarray(image), border_value=border_value))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    strel = ndimage.generate_binary_structure(len(shape) - 2, 1)
    for b in range(shape[0]):
        for c in range(shape[1]):
            ref = ndimage.binary_erosion(image[b, c], strel, border_value=border_value)
            np.testing.assert_array_equal(got.numpy()[b, c], ref.astype(np.uint8))


def test_binary_erosion_custom_structure_and_origin():
    image = blobs(3, (1, 1, 14, 11), 0.7).astype(np.float32)
    strel = np.ones((3, 2), dtype=np.int32)
    got = P.binary_erosion(torch.from_numpy(image), structure=torch.from_numpy(strel), origin=(1, 0))
    want = np.asarray(J.binary_erosion(jnp.asarray(image), structure=jnp.asarray(strel), origin=(1, 0)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_binary_erosion_errors():
    with pytest.raises(ValueError, match="rank 4 or 5"):
        P.binary_erosion(torch.zeros(3, 3))
    with pytest.raises(ValueError, match="binarized"):
        P.binary_erosion(torch.full((1, 1, 3, 3), 2.0))
    with pytest.raises(ValueError, match="binarized"):
        P.binary_erosion(torch.zeros(1, 1, 3, 3), structure=torch.full((3, 3), 3))


@pytest.mark.parametrize("metric", ["euclidean", "chessboard", "taxicab"])
@pytest.mark.parametrize("engine", ["pytorch", "scipy"])
@pytest.mark.parametrize("sampling", [None, [1.5, 0.75]])
def test_distance_transform_matches_jax(metric, engine, sampling):
    x = blobs(len(metric) + len(engine), (23, 31), 0.45).astype(np.float32)
    got = P.distance_transform(torch.from_numpy(x), sampling=sampling, metric=metric, engine=engine)
    want = np.asarray(J.distance_transform(jnp.asarray(x), sampling=sampling, metric=metric, engine=engine))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=DIST_RTOL, atol=0)


def test_distance_transform_against_scipy_in_many_tiles(monkeypatch):
    monkeypatch.setattr(utils, "_TILE_BYTES", 4096)  # one foreground row a tile
    x = blobs(7, (40, 37), 0.5)
    x[5] = True  # rows without background: their candidates are infinite
    x[30:33] = True
    edt = ndimage.distance_transform_edt(x, [2.0, 0.5])
    got = P.distance_transform(torch.from_numpy(x.astype(np.float32)), sampling=[2.0, 0.5])
    np.testing.assert_allclose(got.numpy(), edt, rtol=DIST_RTOL, atol=0)
    for metric in ("chessboard", "taxicab"):
        cdt = ndimage.distance_transform_cdt(x, metric=metric)
        got = P.distance_transform(torch.from_numpy(x.astype(np.float32)), metric=metric, engine="scipy")
        np.testing.assert_array_equal(got.numpy(), cdt.astype(np.float32))


def test_distance_transform_one_background_pixel_matches_jax():
    x = np.ones((9, 13), dtype=np.float32)
    x[7, 2] = 0
    for metric in ("euclidean", "chessboard", "taxicab"):
        got = P.distance_transform(torch.from_numpy(x), sampling=[0.5, 3.0], metric=metric)
        want = np.asarray(J.distance_transform(jnp.asarray(x), sampling=[0.5, 3.0], metric=metric))
        np.testing.assert_array_equal(got.numpy(), want)


def test_distance_transform_edge_cases_and_errors():
    ones = torch.ones(4, 5)
    assert torch.isinf(P.distance_transform(ones)).all()
    np.testing.assert_array_equal(P.distance_transform(ones).numpy(), np.asarray(J.distance_transform(jnp.ones((4, 5)))))
    assert torch.equal(P.distance_transform(torch.zeros(3, 3)), torch.zeros(3, 3))
    for kwargs, match in [({"x": torch.zeros(2, 2, 2)}, "rank 2"), ({"sampling": (1, 1)}, "type `list`"),
                          ({"metric": "cosine"}, "`metric`"), ({"engine": "numpy"}, "`engine`"),
                          ({"sampling": [1, 2, 3]}, "length 2")]:
        args = {"x": torch.zeros(3, 3), **kwargs}
        with pytest.raises(ValueError, match=match):
            P.distance_transform(**args)


@pytest.mark.parametrize("crop", [True, False])
@pytest.mark.parametrize("spacing", [None, (1, 1), (2, 3)])
def test_mask_edges_2d_matches_jax(crop, spacing):
    preds, target = blobs(1, (19, 21)), blobs(2, (19, 21))
    got = P.mask_edges(torch.from_numpy(preds), torch.from_numpy(target), crop=crop, spacing=spacing)
    want = J.mask_edges(jnp.asarray(preds), jnp.asarray(target), crop=crop, spacing=spacing)
    assert len(got) == len(want) == (2 if spacing is None else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("spacing", [(1, 1, 1), (1.5, 2, 0.5)])
def test_mask_edges_3d_codes_and_areas_match_jax_and_numpy(spacing):
    preds, target = blobs(3, (9, 10, 11)), blobs(4, (9, 10, 11))
    got = P.mask_edges(torch.from_numpy(preds), torch.from_numpy(target), spacing=spacing)
    want = J.mask_edges(jnp.asarray(preds), jnp.asarray(target), spacing=spacing)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the codes by hand: each 2x2x2 cube's bits weighted 128 .. 1, after the one-voxel crop pad
    vol = np.pad(preds, 1).astype(np.int64)
    codes = sum(vol[i:vol.shape[0] - 1 + i, j:vol.shape[1] - 1 + j, k:vol.shape[2] - 1 + k] << (7 - (4 * i + 2 * j + k))
                for i in (0, 1) for j in (0, 1) for k in (0, 1))
    np.testing.assert_array_equal(got[0].numpy(), (codes != 0) & (codes != 255))
    table, _ = utils._table_surface_area(tuple(spacing))
    np.testing.assert_allclose(got[2].numpy(), table.numpy()[codes], rtol=1e-6)


def test_mask_edges_empty_and_errors():
    empty = torch.zeros(6, 6, dtype=torch.bool)
    got = P.mask_edges(empty, empty)
    want = J.mask_edges(jnp.zeros((6, 6), bool), jnp.zeros((6, 6), bool))
    assert len(got) == len(want) == 4 and not any(g.any() for g in got)
    with pytest.raises(RuntimeError, match="same shape"):
        P.mask_edges(torch.zeros(3, 3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="rank 2 or 3"):
        P.mask_edges(torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="binarized"):
        P.mask_edges(torch.full((3, 3), 2), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="length 2 or 3"):
        P.mask_edges(torch.zeros(3, 3), torch.zeros(3, 3), spacing=(1,))
    with pytest.raises(ValueError, match="match the input rank"):
        P.mask_edges(torch.zeros(3, 3), torch.zeros(3, 3), spacing=(1, 1, 1))


@pytest.mark.parametrize("metric", ["euclidean", "chessboard", "taxicab"])
@pytest.mark.parametrize("spacing", [None, [0.5, 2.0]])
def test_surface_distance_matches_jax(metric, spacing):
    preds, target = blobs(5, (24, 20), 0.3), blobs(6, (24, 20), 0.35)
    got = P.surface_distance(torch.from_numpy(preds), torch.from_numpy(target), distance_metric=metric, spacing=spacing)
    want = np.asarray(J.surface_distance(jnp.asarray(preds), jnp.asarray(target), distance_metric=metric,
                                         spacing=spacing))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=DIST_RTOL, atol=0)


def test_surface_distance_empty_masks_and_dtype_error():
    some = torch.from_numpy(blobs(8, (8, 8), 0.3))
    empty = torch.zeros(8, 8, dtype=torch.bool)
    for p, t in ((some, empty), (empty, some), (empty, empty)):
        got = P.surface_distance(p, t)
        want = np.asarray(J.surface_distance(jnp.asarray(p.numpy()), jnp.asarray(t.numpy())))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="type `bool`"):
        P.surface_distance(some.float(), some)


def test_check_if_binarized():
    P.check_if_binarized(torch.tensor([0.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="binarized"):
        P.check_if_binarized(torch.tensor([0.0, 0.5]))
