"""Functional segmentation utilities (port of ``torchmetrics_tpu/functional/segmentation/__init__.py``)."""

from torchmetrics_tpu_torch.functional.segmentation.utils import (
    binary_erosion,
    check_if_binarized,
    distance_transform,
    generate_binary_structure,
    mask_edges,
    surface_distance,
)

__all__ = [
    "binary_erosion",
    "check_if_binarized",
    "distance_transform",
    "generate_binary_structure",
    "mask_edges",
    "surface_distance",
]
