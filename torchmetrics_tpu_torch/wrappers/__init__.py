"""Wrapper metrics ported so far: ``Running`` (reference ``torchmetrics/wrappers/``)."""

from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.running import Running

__all__ = ["WrapperMetric", "Running"]
