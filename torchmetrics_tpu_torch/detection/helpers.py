"""Shared input checks for the detection domain (port of ``torchmetrics_tpu/detection/helpers.py``).

Covers the cases the reference guards (sample lists, per-sample dict fields,
matching per-sample lengths) as a field-spec table walked once per sample.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

# iou_type -> the per-sample field holding the geometry for that matching mode
_GEOMETRY_FIELD = {"bbox": "boxes", "segm": "masks"}


def _validate_iou_type_arg(iou_type: Union[str, Tuple[str, ...]] = "bbox") -> Tuple[str, ...]:
    """Normalize ``iou_type`` to a tuple, rejecting unknown modes."""
    types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
    bad = [t for t in types if t not in _GEOMETRY_FIELD]
    if bad:
        raise ValueError(
            f"Expected argument `iou_type` to be one of {tuple(_GEOMETRY_FIELD)} or a list of, but got {iou_type}"
        )
    return types


def _num_rows(value: Any) -> int:
    shape = getattr(value, "shape", None)
    if shape is not None:
        return shape[0]
    return np.asarray(value).shape[0]


def _check_samples(
    role: str, samples: Sequence[Dict[str, Any]], fields: Tuple[str, ...], aligned: Tuple[str, ...]
) -> None:
    """Every sample dict must carry ``fields``, with ``aligned`` row counts equal."""
    for field in fields:
        if any(field not in sample for sample in samples):
            raise ValueError(f"Expected all dicts in `{role}` to contain the `{field}` key")
    for idx, sample in enumerate(samples):
        lengths = {_num_rows(sample[field]) for field in aligned}
        if len(lengths) > 1:
            raise ValueError(f"Sample {idx} in `{role}` has mismatched lengths across {aligned}")


def _input_validator(
    preds: Sequence[Dict[str, Any]],
    targets: Sequence[Dict[str, Any]],
    iou_type: Union[str, Tuple[str, ...]] = "bbox",
    ignore_score: bool = False,
) -> None:
    """Validate a (preds, targets) pair of per-image detection dicts."""
    if isinstance(iou_type, str):
        iou_type = (iou_type,)
    unknown = [t for t in iou_type if t not in _GEOMETRY_FIELD]
    if unknown:
        raise Exception(f"IOU type {iou_type} is not supported")
    geometry = tuple(_GEOMETRY_FIELD[t] for t in iou_type)

    for role, seq in (("preds", preds), ("target", targets)):
        if not isinstance(seq, Sequence):
            raise ValueError(f"Expected argument `{role}` to be of type Sequence, but got {seq}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    # score-free callers (IntersectionOverUnion) only need the keys present;
    # row alignment of predictions is enforced when scores participate
    pred_fields = geometry + (("labels",) if ignore_score else ("labels", "scores"))
    _check_samples("preds", preds, pred_fields, () if ignore_score else pred_fields)
    _check_samples("target", targets, geometry + ("labels",), geometry + ("labels",))


def _fix_empty_tensors(boxes: Tensor) -> Tensor:
    """Canonicalize a zero-detection box tensor to shape ``(0, 4)``."""
    if boxes.numel() == 0 and boxes.ndim == 1:
        return boxes.reshape(0, 4)
    return boxes


def _as_tensor(x: Any, dtype: torch.dtype, device: torch.device) -> Tensor:
    """``x`` as a tensor of ``dtype`` on ``device``; a tensor already so is passed through untouched."""
    if isinstance(x, Tensor) and x.dtype == dtype and x.device == device:
        return x
    return torch.as_tensor(np.asarray(x) if not isinstance(x, Tensor) else x, dtype=dtype, device=device)
