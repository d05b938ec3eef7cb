"""Segmentation morphology utilities (port of ``torchmetrics_tpu/functional/segmentation/utils.py``).

- ``binary_erosion`` is a convolution-equality test (``conv(img, strel) ==
  strel.sum()``), one ``conv2d``/``conv3d`` in full float32 (exact counts);
- ``distance_transform`` (both engines) gives each foreground pixel its exact
  least distance to a background pixel, on the input's device. The JAX eager
  path builds the whole ``[n_fg, n_bg]`` matrix in numpy (a half-filled
  512x512 slice: 69 GB), its jit form ``(HW)^2``. Here the search goes
  through rows: within a row the nearest background pixel to a column is one
  of two (cumulative maxima from both sides), so a pixel's minimum is taken
  over one candidate a row, ``H`` instead of ``n_bg``, in tiles of
  foreground rows whose ``[rows, H, W]`` temporaries stay under
  ``_TILE_BYTES``. Every candidate's distance is the float32 expression of
  the JAX form (``|di| s0``, ``|dj| s1``, their squares' sum, max or sum),
  and rounding is monotonic, so the minima are the same numbers; the root
  of the Euclidean minimum is taken after it (the float64 root rounded
  once: float32's correctly rounded root), which gives the same float32
  value as the minimum of the roots. ``engine="scipy"`` gives scipy's
  distances by the same exact search in float64, returned as float32, as
  the JAX package returns them under its default x64-off;
- ``mask_edges``' neighbour codes come from a convolution with the bit
  weights, under ``full_fp32`` so the codes are exact integers;
- ``surface_distance`` indexes by boolean masks (data-dependent sizes), as
  the reference does.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.metric import _resolve_device
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.compute import full_fp32

_TILE_BYTES = 256 * 2**20  # the temporaries of one tile of distance_transform: two [rows, H, W]
_TILE_MATRICES = 2


def check_if_binarized(x: Tensor) -> None:
    """Raise if the tensor holds values other than 0 and 1."""
    if not bool(torch.all((x == 0) | (x == 1))):
        raise ValueError("Input x should be binarized")


def generate_binary_structure(rank: int, connectivity: int, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """Binary structuring element as ``scipy.ndimage.generate_binary_structure``, on ``device`` (``cuda`` unless given).

    Example:
        >>> generate_binary_structure(2, 1, device="cpu").int()
        tensor([[0, 1, 0],
                [1, 1, 1],
                [0, 1, 0]], dtype=torch.int32)
    """
    device = _resolve_device(device)
    if connectivity < 1:
        connectivity = 1
    if rank < 1:
        return torch.tensor(True, device=device)
    grids = torch.meshgrid(*([torch.arange(3, device=device) - 1] * rank), indexing="ij")
    absdist = sum(torch.abs(g) for g in grids)
    return absdist <= connectivity


def binary_erosion(
    image: Tensor,
    structure: Optional[Tensor] = None,
    origin: Optional[Tuple[int, ...]] = None,
    border_value: int = 0,
) -> Tensor:
    """Binary erosion of a ``(B, C, H, W)`` or ``(B, C, D, H, W)`` image, as uint8."""
    if image.ndim not in [4, 5]:
        raise ValueError(f"Expected argument `image` to be of rank 4 or 5 but found rank {image.ndim}")
    check_if_binarized(image)
    spatial_rank = image.ndim - 2
    if structure is None:
        structure = generate_binary_structure(spatial_rank, 1, device=image.device).to(torch.int32)
    else:
        structure = torch.as_tensor(structure, device=image.device)
        check_if_binarized(structure)
        structure = structure.to(torch.int32)
    if origin is None:
        origin = structure.ndim * (1,)

    # pad so that the structuring element's origin sweeps every pixel
    pads: List[int] = []
    for i in reversed(range(len(origin))):
        pads += [origin[i], structure.shape[i] - origin[i] - 1]
    image_pad = F.pad(image.to(torch.float32), pads, mode="constant", value=float(border_value))
    batch, chan = image_pad.shape[:2]
    flat = image_pad.reshape(batch * chan, 1, *image_pad.shape[2:])
    kernel = structure.to(torch.float32)[None, None]
    conv = F.conv2d if spatial_rank == 2 else F.conv3d
    with full_fp32():  # the window's count of ones, exact
        hits = conv(flat, kernel)
    eroded = (hits >= float(structure.sum()) - 0.5).reshape(image.shape)
    return eroded.to(torch.uint8)


def _row_min_distance(fg: Tensor, bg: Tensor, scale: Tuple[float, float], metric: str, dtype: torch.dtype) -> Tensor:
    """``(H, W)``: at each pixel of a row holding foreground, its least distance to a background pixel.

    ``fg``, ``bg``: boolean ``(H, W)`` masks; ``bg`` holds at least one pixel.
    Euclidean distances are returned squared (the caller takes the root).
    """
    h, w = bg.shape
    cols = torch.arange(w, device=bg.device)
    far = 2 * (h + w)
    # the nearest background column to each column, in each row: the last one at or left of it, the first one at
    # or right of it (cumulative maxima, the second on the flipped row)
    left = torch.where(bg, cols, -far).cummax(dim=1).values
    right = w - 1 - torch.flip(torch.where(torch.flip(bg, dims=(1,)), cols, -far).cummax(dim=1).values, dims=(1,))
    nearest = torch.minimum(cols - left, right - cols)
    dis_col = torch.where(bg.any(dim=1, keepdim=True), nearest.to(dtype) * scale[1], float("inf"))  # [H, W]
    out = torch.zeros((h, w), dtype=dtype, device=bg.device)
    fg_rows = torch.nonzero(fg.any(dim=1)).reshape(-1)
    rows = max(1, _TILE_BYTES // (_TILE_MATRICES * h * w * torch.finfo(dtype).bits // 8))
    all_rows = torch.arange(h, device=bg.device)
    col_sq = dis_col * dis_col
    for start in range(0, fg_rows.shape[0], rows):
        tile = fg_rows[start:start + rows]
        dis_row = (tile[:, None] - all_rows[None, :]).abs().to(dtype) * scale[0]  # [rows, H]: to each row r
        if metric == "euclidean":
            cand = (dis_row * dis_row)[:, :, None] + col_sq[None]
        elif metric == "chessboard":
            cand = torch.maximum(dis_row[:, :, None], dis_col[None])
        else:
            cand = dis_row[:, :, None] + dis_col[None]
        out[tile] = torch.amin(cand, dim=1)
    return out


def distance_transform(
    x: Tensor,
    sampling: Optional[Union[Tensor, List[float]]] = None,
    metric: str = "euclidean",
    engine: str = "pytorch",
) -> Tensor:
    """Distance transform of a rank-2 binary tensor: each foreground pixel becomes its distance to the closest background pixel.

    Example:
        >>> import torch
        >>> x = torch.zeros(5, 5); x[1:4, 1:4] = 1
        >>> distance_transform(x)
        tensor([[0., 0., 0., 0., 0.],
                [0., 1., 1., 1., 0.],
                [0., 1., 2., 1., 0.],
                [0., 1., 1., 1., 0.],
                [0., 0., 0., 0., 0.]])
    """
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be of rank 2 but got rank `{x.ndim}`.")
    if sampling is not None and not isinstance(sampling, list):
        raise ValueError(
            f"Expected argument `sampling` to either be `None` or of type `list` but got `{type(sampling)}`."
        )
    if metric not in ["euclidean", "chessboard", "taxicab"]:
        raise ValueError(
            f"Expected argument `metric` to be one of `['euclidean', 'chessboard', 'taxicab']` but got `{metric}`."
        )
    if engine not in ["pytorch", "scipy"]:
        raise ValueError(f"Expected argument `engine` to be one of `['pytorch', 'scipy']` but got `{engine}`.")
    if sampling is None:
        sampling = [1, 1]
    elif len(sampling) != 2:
        raise ValueError(f"Expected argument `sampling` to have length 2 but got length `{len(sampling)}`.")

    if engine == "scipy":
        # scipy's edt honours the sampling, in float64; its chamfer transform (cdt) does not, and is exact on
        # the grid for these two metrics; both treat every nonzero pixel as foreground
        fg_mask, bg_mask = x != 0, x == 0
        scale = (float(sampling[0]), float(sampling[1])) if metric == "euclidean" else (1.0, 1.0)
        dtype = torch.float64
    else:
        fg_mask, bg_mask = x == 1, x == 0
        scale = (sampling[0], sampling[1])
        dtype = torch.float32
    if not bool(bg_mask.any()):  # no background: every foreground pixel is infinitely far
        return torch.where(fg_mask, float("inf"), 0.0).to(torch.float32)
    dist = _row_min_distance(fg_mask, bg_mask, scale, metric, dtype)
    if metric == "euclidean":
        # float32's correctly rounded root, as numpy's: the float64 root rounded once (torch's CPU root is not)
        dist = torch.sqrt(dist.to(torch.float64))
    return torch.where(fg_mask, dist, 0.0).to(torch.float32)


def mask_edges(
    preds: Tensor,
    target: Tensor,
    crop: bool = True,
    spacing: Optional[Union[Tuple[int, int], Tuple[int, int, int]]] = None,
) -> Union[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """Edges of binary segmentation masks (erosion XOR mask); with ``spacing`` also the neighbour-code
    weights: 2D contour lengths or 3D marching-cubes surface areas."""
    _check_same_shape(preds, target)
    if preds.ndim not in [2, 3]:
        raise ValueError(f"Expected argument `preds` to be of rank 2 or 3 but got rank `{preds.ndim}`.")
    check_if_binarized(preds)
    check_if_binarized(target)
    preds = preds.to(torch.bool)
    target = target.to(torch.bool)
    if spacing is not None:
        if len(spacing) not in (2, 3):
            raise ValueError("The spacing must be a tuple of length 2 or 3.")
        if len(spacing) != preds.ndim:
            raise ValueError(
                f"Expected `spacing` length to match the input rank, but got {len(spacing)} and rank {preds.ndim}."
            )

    if crop:
        if not bool((preds | target).any()):
            p, t = torch.zeros_like(preds), torch.zeros_like(target)
            return p, t, p, t
        pads = [1, 1] * preds.ndim
        preds = F.pad(preds.to(torch.uint8), pads).to(torch.bool)
        target = F.pad(target.to(torch.uint8), pads).to(torch.bool)

    if spacing is None:
        shape4 = (1, 1, *preds.shape)
        be_pred = binary_erosion(preds.reshape(shape4).to(torch.int32)).reshape(preds.shape).to(torch.bool) ^ preds
        be_target = binary_erosion(target.reshape(shape4).to(torch.int32)).reshape(target.shape).to(torch.bool) ^ target
        return be_pred, be_target

    if len(spacing) == 2:
        table, kernel = _table_contour_length(tuple(spacing))
        conv = F.conv2d
    else:
        table, kernel = _table_surface_area(tuple(spacing))
        conv = F.conv3d
    table, kernel = table.to(preds.device), kernel.to(preds.device)
    volume = torch.stack([preds, target])[:, None].to(torch.float32)  # [2, 1, *spatial]
    with full_fp32():  # the neighbour codes are sums of at most 255 exact powers of two
        codes = conv(volume, kernel).to(torch.int64)
    code_preds, code_target = codes[0], codes[1]
    all_ones = table.shape[0] - 1
    edges_preds = (code_preds != 0) & (code_preds != all_ones)
    edges_target = (code_target != 0) & (code_target != all_ones)
    return edges_preds[0], edges_target[0], table[code_preds][0], table[code_target][0]


def _table_contour_length(spacing: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
    """2D neighbour code -> contour length (the surface-distance convention: 2x2 bits weighted 8/4/2/1)."""
    first, second = spacing
    diag = 0.5 * math.sqrt(first**2 + second**2)
    table = [0.0] * 16
    for i in (1, 2, 4, 7, 8, 11, 13, 14):
        table[i] = diag
    for i in (3, 12):
        table[i] = float(second)
    for i in (5, 10):
        table[i] = float(first)
    for i in (6, 9):
        table[i] = 2 * diag
    kernel = torch.tensor([[[[8.0, 4.0], [2.0, 1.0]]]])
    return torch.tensor(table, dtype=torch.float32), kernel


# 2x2x2 neighbour code -> marching-cubes sub-triangle surface normals, packed: 256 codes x up to 4 normals x 3
# components, every component a multiple of 1/8 in [-0.5, 0.5], one char each as chr(ord('0') + 8 * v + 4).
# Public data (DeepMind surface-distance ``lookup_tables.py``, Apache-2.0), as the JAX package carries it.
_MC_NORMALS_PACKED = (
    "444444444444555444444444335444444444224664444444535444444444242646444444535335444444844666555444"
    "355444444444555355444444246246444444844226335444624624444444844626353444044266355444844844444444"
    "533444444444422466444444335533444444404666555444535533444444440666333444335535533444333222666555"
    "355533444444422466355444246246533444555777426246533624624444777462333264044333222555044333222444"
    "535444444444555535444444426462444444404553662444535535444444535242646444426462535444117466553242"
    "355535444444555535355444448226335444662662553335535624624444844626353535462711355664044226335444"
    "624264444444484266533444484535262444484404444444624264535444111246333264555404222333404222333444"
    "355624264444484662335335171224353246484662335444624264624624224224335444555224224444224224444444"
    "335444444444555335444444335335444444335224664444426426444444448626535444426426335444717422353664"
    "335355444444555335355444335246246444844226335335484262535444262262353353242711462355844262535444"
    "246642444444448266355444335246642444242177224355440662335444448448444444555555666448555666448444"
    "246642355444448626535535246246246642535646646444646117264335448626535444555646646444646646444444"
    "335535444444555335535444335426462444404553662335426426535444448626535535426426426462466466533444"
    "355535335444355535335555448226335335555535533444484262535535555335533444422466555444555533444444"
    "844622533444266355266533717466353246404266355444117624466335355266448444555466466444466466444444"
    "844666555555535335555444242646555444555535444444224664555444555335444444555555444444555444444444"
    "555444444444555555444444555335444444224664555444555535444444242646555444535335555444844666555555"
    "466466444444555466466444355266448444117624466335404266355444717466353246266355266533844622533444"
    "555533444444422466555444555335533444484262535535555535533444448226335335355535335555355535335444"
    "466466533444422466466466448626535535426426535444404553662335335426462444555335535444335535444444"
    "646646444444555646646444448626535444646117264335535646646444242646646646448626535535246642355444"
    "555666448444555555666448448448444444440662335444242177224355335246642444448266355444246642444444"
    "844262535444242711462355262262353353484262535444844226335335335246246444555335355444335355444444"
    "717422353664426426335444448626535444426426444444335224664444335335444444555335444444335444444444"
    "224224444444555224224444224224335444224224224664484662335444171224353246484662335335355624264444"
    "404222333444555404222333111246333264624264535444484404444444484535262444484266533444624264444444"
    "044226335444462711355664844626353535535624624444662662553335448226335444555535355444355535444444"
    "117466553242426462535444535242646444535535444444404553662444426462444444555535444444535444444444"
    "044333222444044333222555777462333264533624624444555777426246246246533444422466355444355533444444"
    "333222666555335535533444440666333444535533444444404666555444335533444444422466444444533444444444"
    "844844444444044266355444844626353444624624444444844226335444246246444444555355444444355444444444"
    "844666555444535335444444242646444444555444444444224664444444555444444444555444444444444444444444"
)


@lru_cache(maxsize=None)
def _table_surface_area(spacing: Tuple[int, int, int]) -> Tuple[Tensor, Tensor]:
    """3D neighbour code -> surface area: the summed magnitude of each code's marching-cubes normals, each axis
    scaled by the voxel face areas ``(s1 s2, s0 s2, s0 s1)``; bits weighted 128/64/32/16/8/4/2/1."""
    flat = np.frombuffer(_MC_NORMALS_PACKED.encode("ascii"), dtype=np.uint8).astype(np.float64)
    normals = ((flat - ord("0") - 4) / 8.0).reshape(256, 4, 3)
    s0, s1, s2 = spacing
    scale = np.asarray([s1 * s2, s0 * s2, s0 * s1], dtype=np.float64)
    table = np.linalg.norm(normals * scale, axis=-1).sum(-1)
    kernel = torch.tensor([[[[[128.0, 64.0], [32.0, 16.0]], [[8.0, 4.0], [2.0, 1.0]]]]])
    return torch.from_numpy(table.astype(np.float32)), kernel


def surface_distance(
    preds: Tensor,
    target: Tensor,
    distance_metric: str = "euclidean",
    spacing: Optional[Union[Tensor, List[float]]] = None,
) -> Tensor:
    """Distances from each edge pixel of ``preds`` to the closest edge pixel of ``target``.

    Example:
        >>> import torch
        >>> preds = torch.ones(5, 5, dtype=torch.bool); preds[1:4, 1:4] = False
        >>> float(surface_distance(preds, preds).max())
        0.0
    """
    if not (preds.dtype == torch.bool and target.dtype == torch.bool):
        raise ValueError(f"Expected both inputs to be of type `bool`, but got {preds.dtype} and {target.dtype}.")
    if not bool(torch.any(target)):
        dis = torch.full(target.shape, float("inf"), device=target.device)
    elif not bool(torch.any(preds)):
        dis = torch.full(preds.shape, float("inf"), device=preds.device)
        return dis[target]
    else:
        dis = distance_transform(~target, sampling=spacing, metric=distance_metric)
    return dis[preds]
