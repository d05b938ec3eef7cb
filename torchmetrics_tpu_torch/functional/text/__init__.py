from torchmetrics_tpu_torch.functional.text.bert import bert_score
from torchmetrics_tpu_torch.functional.text.bleu import bleu_score
from torchmetrics_tpu_torch.functional.text.cer import char_error_rate
from torchmetrics_tpu_torch.functional.text.chrf import chrf_score
from torchmetrics_tpu_torch.functional.text.edit import edit_distance
from torchmetrics_tpu_torch.functional.text.eed import extended_edit_distance
from torchmetrics_tpu_torch.functional.text.infolm import infolm
from torchmetrics_tpu_torch.functional.text.mer import match_error_rate
from torchmetrics_tpu_torch.functional.text.perplexity import perplexity
from torchmetrics_tpu_torch.functional.text.rouge import rouge_score
from torchmetrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
from torchmetrics_tpu_torch.functional.text.squad import squad
from torchmetrics_tpu_torch.functional.text.ter import translation_edit_rate
from torchmetrics_tpu_torch.functional.text.wer import word_error_rate
from torchmetrics_tpu_torch.functional.text.wil import word_information_lost
from torchmetrics_tpu_torch.functional.text.wip import word_information_preserved

__all__ = [
    "bert_score",
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "edit_distance",
    "extended_edit_distance",
    "infolm",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
