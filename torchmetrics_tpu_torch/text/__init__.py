from torchmetrics_tpu_torch.text.bert import BERTScore
from torchmetrics_tpu_torch.text.bleu import BLEUScore
from torchmetrics_tpu_torch.text.cer import CharErrorRate
from torchmetrics_tpu_torch.text.chrf import CHRFScore
from torchmetrics_tpu_torch.text.edit import EditDistance
from torchmetrics_tpu_torch.text.eed import ExtendedEditDistance
from torchmetrics_tpu_torch.text.infolm import InfoLM
from torchmetrics_tpu_torch.text.mer import MatchErrorRate
from torchmetrics_tpu_torch.text.perplexity import Perplexity
from torchmetrics_tpu_torch.text.rouge import ROUGEScore
from torchmetrics_tpu_torch.text.sacre_bleu import SacreBLEUScore
from torchmetrics_tpu_torch.text.squad import SQuAD
from torchmetrics_tpu_torch.text.ter import TranslationEditRate
from torchmetrics_tpu_torch.text.wer import WordErrorRate
from torchmetrics_tpu_torch.text.wil import WordInfoLost
from torchmetrics_tpu_torch.text.wip import WordInfoPreserved

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
