"""Pairwise box and mask similarity (port of ``torchmetrics_tpu/functional/detection/_pairwise.py``).

Each function is a fixed-shape ``(N, 4) x (M, 4) -> (N, M)`` broadcast of
elementwise torch ops, the counterpart of ``torchvision.ops.box_iou`` and its
generalized, distance and complete variants. Boxes are ``xyxy`` unless
converted with :func:`box_convert`. Mask IoU is one float32 product of the
flattened masks with TF32 off, so pixel counts stay exact below 2**24.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import full_fp32

_EPS = 1e-7


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str = "xyxy") -> Tensor:
    """Convert boxes between ``xyxy`` / ``xywh`` / ``cxcywh`` formats."""
    allowed = ("xyxy", "xywh", "cxcywh")
    if in_fmt not in allowed or out_fmt not in allowed:
        raise ValueError(f"Box formats must be one of {allowed}, got {in_fmt} -> {out_fmt}")
    if in_fmt == out_fmt:
        return boxes
    x, y, a, b = boxes.unbind(-1)
    if in_fmt == "xywh":
        xyxy = torch.stack([x, y, x + a, y + b], dim=-1)
    elif in_fmt == "cxcywh":
        xyxy = torch.stack([x - a / 2, y - b / 2, x + a / 2, y + b / 2], dim=-1)
    else:
        xyxy = boxes
    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = xyxy.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(boxes: Tensor) -> Tensor:
    """Area of ``xyxy`` boxes, shape ``(..., 4) -> (...,)``."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(boxes1: Tensor, boxes2: Tensor):
    """Pairwise intersection and union over the last two axes: ``(..., N, 4), (..., M, 4) -> (..., N, M)`` twice."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter, union


def _enclosure(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Width and height of the smallest box enclosing each pair: ``(N, M, 2)``."""
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    return rb - lt


def pairwise_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU matrix (vs ``torchvision.ops.box_iou``)."""
    inter, union = _inter_union(boxes1, boxes2)
    return inter / torch.clamp_min(union, _EPS)


def pairwise_giou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise generalized IoU: ``iou - (enclosure - union) / enclosure``."""
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / torch.clamp_min(union, _EPS)
    wh = torch.clamp_min(_enclosure(boxes1, boxes2), 0)
    enclosure = wh[..., 0] * wh[..., 1]
    return iou - (enclosure - union) / torch.clamp_min(enclosure, _EPS)


def _diou_iou(boxes1: Tensor, boxes2: Tensor):
    """Shared DIoU/CIoU core: ``(diou, iou)`` pairwise matrices."""
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / torch.clamp_min(union, _EPS)
    wh = _enclosure(boxes1, boxes2)
    diag_sq = wh[..., 0] ** 2 + wh[..., 1] ** 2
    cx1 = (boxes1[:, 0] + boxes1[:, 2]) / 2
    cy1 = (boxes1[:, 1] + boxes1[:, 3]) / 2
    cx2 = (boxes2[:, 0] + boxes2[:, 2]) / 2
    cy2 = (boxes2[:, 1] + boxes2[:, 3]) / 2
    dist_sq = (cx1[:, None] - cx2[None, :]) ** 2 + (cy1[:, None] - cy2[None, :]) ** 2
    return iou - dist_sq / torch.clamp_min(diag_sq, _EPS), iou


def pairwise_diou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise distance IoU (vs ``torchvision.ops.distance_box_iou``)."""
    return _diou_iou(boxes1, boxes2)[0]


def pairwise_ciou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise complete IoU (vs ``torchvision.ops.complete_box_iou``)."""
    diou, iou = _diou_iou(boxes1, boxes2)
    w1 = boxes1[:, 2] - boxes1[:, 0]
    h1 = boxes1[:, 3] - boxes1[:, 1]
    w2 = boxes2[:, 2] - boxes2[:, 0]
    h2 = boxes2[:, 3] - boxes2[:, 1]
    v = (4.0 / (math.pi**2)) * (
        torch.arctan(w1 / torch.clamp_min(h1, _EPS))[:, None] - torch.arctan(w2 / torch.clamp_min(h2, _EPS))[None, :]
    ) ** 2
    # alpha is a weight, not a gradient path (torchvision computes it without grad)
    alpha = (v / torch.clamp_min(1 - iou + v, _EPS)).detach()
    return diou - alpha * v


def _mask_inter_areas(masks1: Tensor, masks2: Tensor):
    """Pixel intersections ``(N, M)`` and areas of two stacks of masks, each ``(N, H, W)``, counted in float32."""
    m1 = masks1.reshape(masks1.shape[0], -1).to(torch.float32)
    m2 = masks2.reshape(masks2.shape[0], -1).to(torch.float32)
    with full_fp32():
        inter = m1 @ m2.T
    return inter, m1.sum(dim=1), m2.sum(dim=1)


def pairwise_mask_iou(masks1: Tensor, masks2: Tensor) -> Tensor:
    """Pairwise IoU between dense binary masks ``(N,H,W),(M,H,W) -> (N,M)``."""
    inter, area1, area2 = _mask_inter_areas(masks1, masks2)
    union = area1[:, None] + area2[None, :] - inter
    return inter / torch.clamp_min(union, 1.0)


def pairwise_mask_iou_crowd(masks1: Tensor, masks2: Tensor, iscrowd: Tensor) -> Tensor:
    """Mask IoU with COCO crowd semantics: crowd columns use the detection's area as denominator."""
    inter, area1, area2 = _mask_inter_areas(masks1, masks2)
    union = area1[:, None] + area2[None, :] - inter
    denom = torch.where(iscrowd[None, :].bool(), area1[:, None], union)
    return inter / torch.clamp_min(denom, 1.0)


def pairwise_iou_crowd(boxes1: Tensor, boxes2: Tensor, iscrowd: Tensor) -> Tensor:
    """Box IoU with COCO crowd semantics (``maskUtils.iou``'s iscrowd flag), batched over leading axes:
    for crowd ground-truth columns the denominator is the detection's area."""
    inter, union = _inter_union(boxes1, boxes2)
    area1 = box_area(boxes1)
    denom = torch.where(iscrowd[..., None, :].bool(), area1[..., :, None], union)
    return inter / torch.clamp_min(denom, _EPS)
