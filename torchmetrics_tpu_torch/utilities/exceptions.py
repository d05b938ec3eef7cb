"""Typed exceptions for the PyTorch metrics framework.

API-parity with reference ``torchmetrics/utilities/exceptions.py``.
"""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metrics API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on questionable usage of the metrics API."""
