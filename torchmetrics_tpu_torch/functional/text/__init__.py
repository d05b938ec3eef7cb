from torchmetrics_tpu_torch.functional.text.bert import bert_score
from torchmetrics_tpu_torch.functional.text.infolm import infolm

__all__ = ["bert_score", "infolm"]
