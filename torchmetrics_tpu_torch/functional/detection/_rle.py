"""COCO RLE mask codec (port of ``torchmetrics_tpu/functional/detection/_rle.py``).

Masks stay dense on the device (mask IoU is a matrix product); RLE is only
needed at the COCO-JSON interchange boundary (``coco_to_tm`` /
``tm_to_coco``). The codec is the port's own C source, ``csrc/rle.c``, built
with the system C compiler into ``_build/`` at first use and called through
``ctypes``; a failed build raises. The pure-Python ``*_plain`` functions beside
each entry point are its plain version, the reference the tests hold it to.

COCO RLE conventions: column-major (Fortran) scan order; ``counts`` starts
with the number of zeros; the compressed string form packs each count as a
base-48 LEB128-style varint with 5-bit groups and delta-codes counts[i>2]
against counts[i-2] (see pycocotools ``rleToString``/``rleFrString``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Union

import numpy as np

from torchmetrics_tpu_torch.utilities import nvcc

SOURCE = nvcc.CSRC_DIR / "rle.c"
_LONG = np.dtype(ctypes.c_long)


@functools.cache
def _library() -> Any:
    lib = nvcc.load_c(SOURCE)
    u8p, lp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long)
    lib.tm_mask_to_counts.argtypes = [u8p, ctypes.c_long, lp]
    lib.tm_mask_to_counts.restype = ctypes.c_long
    lib.tm_counts_to_mask.argtypes = [lp, ctypes.c_long, u8p, ctypes.c_long]
    lib.tm_counts_to_mask.restype = None
    lib.tm_string_encode.argtypes = [lp, ctypes.c_long, ctypes.c_char_p]
    lib.tm_string_encode.restype = ctypes.c_long
    lib.tm_string_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, lp]
    lib.tm_string_decode.restype = ctypes.c_long
    return lib


def _flat_binary(mask: np.ndarray) -> np.ndarray:
    # binarize BEFORE any narrowing cast: nonzero = foreground (0/255 PNGs,
    # int32 instance-id masks whose values may be multiples of 256, ...)
    return np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8).flatten(order="F"))


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Dense (H, W) binary mask → uncompressed COCO counts list."""
    flat = _flat_binary(mask)
    if flat.size == 0:
        return []
    out = np.empty(flat.size + 1, dtype=_LONG)
    m = _library().tm_mask_to_counts(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_long))
    )
    return out[:m].tolist()


def mask_to_rle_counts_plain(mask: np.ndarray) -> List[int]:
    flat = _flat_binary(mask)
    if flat.size == 0:
        return []
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0]:  # counts must start with a zero-run
        runs = [0, *runs]
    return [int(r) for r in runs]


def rle_counts_to_mask(counts: List[int], size: List[int]) -> np.ndarray:
    """Uncompressed COCO counts list + (H, W) size → dense uint8 mask."""
    h, w = int(size[0]), int(size[1])
    carr = np.ascontiguousarray(np.asarray(counts, dtype=_LONG))
    flat = np.zeros(h * w, dtype=np.uint8)
    _library().tm_counts_to_mask(
        carr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), carr.size,
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size,
    )
    return flat.reshape((h, w), order="F")


def rle_counts_to_mask_plain(counts: List[int], size: List[int]) -> np.ndarray:
    h, w = int(size[0]), int(size[1])
    flat = np.zeros(h * w, dtype=np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def rle_string_encode(counts: List[int]) -> str:
    """Counts list → compressed COCO RLE string (pycocotools ``rleToString``)."""
    if not len(counts):
        return ""
    carr = np.ascontiguousarray(np.asarray(counts, dtype=_LONG))
    buf = ctypes.create_string_buffer(16 * carr.size)  # 13 five-bit groups at most per 64-bit count
    n = _library().tm_string_encode(carr.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), carr.size, buf)
    return buf.raw[:n].decode("ascii")


def rle_string_encode_plain(counts: List[int]) -> str:
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (chunk & 0x10) or x == -1 and (chunk & 0x10))
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return out.decode("ascii")


def rle_string_decode(s: Union[str, bytes]) -> List[int]:
    """Compressed COCO RLE string → counts list (pycocotools ``rleFrString``)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    if not len(s):
        return []
    out = np.empty(len(s), dtype=_LONG)
    m = _library().tm_string_decode(s, len(s), out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if m == -1:
        raise ValueError("truncated RLE string (continuation bit set on the final byte)")
    if m == -2:
        raise ValueError("overlong RLE varint (corrupt input)")
    return out[:m].tolist()


def rle_string_decode_plain(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            if k >= 13:  # no 64-bit value needs more than 13 five-bit groups
                raise ValueError("overlong RLE varint (corrupt input)")
            if p >= len(s):
                raise ValueError("truncated RLE string (continuation bit set on the final byte)")
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10) and 5 * k < 64:
                x |= -1 << (5 * k)
        x &= (1 << 64) - 1  # normalize to 64-bit two's complement, as the C codec holds it
        if x >= 1 << 63:
            x -= 1 << 64
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def ann_to_mask(segmentation: Union[Dict, List], height: int, width: int) -> np.ndarray:
    """COCO annotation ``segmentation`` field → dense (H, W) uint8 mask.

    Supports uncompressed RLE (``counts`` list) and compressed RLE
    (``counts`` string). Polygon segmentations need a rasterizer and are
    only supported when ``pycocotools`` is installed.
    """
    if isinstance(segmentation, dict):
        counts = segmentation["counts"]
        size = segmentation.get("size", [height, width])
        if isinstance(counts, (str, bytes)):
            counts = rle_string_decode(counts)
        return rle_counts_to_mask(list(counts), size)
    try:
        from pycocotools import mask as _mask_utils  # noqa: PLC0415
    except ImportError as err:
        raise NotImplementedError(
            "Polygon segmentations require `pycocotools` for rasterization; "
            "install it or provide RLE-encoded masks."
        ) from err
    rles = _mask_utils.frPyObjects(segmentation, height, width)
    return np.asarray(_mask_utils.decode(_mask_utils.merge(rles)), dtype=np.uint8)
