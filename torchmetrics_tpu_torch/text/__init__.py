from torchmetrics_tpu_torch.text.bert import BERTScore
from torchmetrics_tpu_torch.text.infolm import InfoLM

__all__ = ["BERTScore", "InfoLM"]
