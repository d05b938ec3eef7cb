__version__ = "0.1.0"
__author__ = "torchmetrics-tpu contributors"
__license__ = "Apache-2.0"
__docs__ = "PyTorch/CUDA port of torchmetrics_tpu: the TorchMetrics capability surface on NVIDIA GPUs."

__all__ = ["__version__", "__author__", "__license__", "__docs__"]
