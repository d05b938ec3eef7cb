"""SacreBLEU (port of ``torchmetrics_tpu/functional/text/sacre_bleu.py``).

BLEU with standardized tokenizers: ``none``, ``13a`` (mteval-v13a), ``zh``,
``intl`` (mteval-v14, from ``unicodedata`` categories, not the ``regex``
package) and ``char``. ``ja-mecab``/``ko-mecab``/``flores*`` need external
tokenizer models and raise.
"""

from __future__ import annotations

import re
import unicodedata
from functools import partial
from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_functional

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

_13A_REGEX = (
    # language-dependent part (assuming Western languages)
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # tokenize period and comma unless preceded by a digit
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    # tokenize period and comma unless followed by a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # tokenize dash when preceded by a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)

_CJK_RANGES = (
    (0x3400, 0x4DB5),
    (0x4E00, 0x9FA5),
    (0x9FA6, 0x9FBB),
    (0xF900, 0xFA2D),
    (0xFA30, 0xFA6A),
    (0xFA70, 0xFAD9),
    (0x20000, 0x2A6D6),
    (0x2F800, 0x2FA1D),
    (0xFF00, 0xFFEF),
    (0x2E80, 0x2EFF),
    (0x3000, 0x303F),
    (0x31C0, 0x31EF),
    (0x2F00, 0x2FDF),
    (0x2FF0, 0x2FFF),
    (0x3100, 0x312F),
    (0x31A0, 0x31BF),
    (0xFE10, 0xFE1F),
    (0xFE30, 0xFE4F),
    (0x2600, 0x26FF),
    (0x2700, 0x27BF),
    (0x3200, 0x32FF),
    (0x3300, 0x33FF),
)


def _is_chinese_char(char: str) -> bool:
    cp = ord(char)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


class _SacreBLEUTokenizer:
    """Standardized sacrebleu-style tokenization (mteval-v13a / zh / intl / char)."""

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_fn = getattr(self, f"_tokenize_{tokenize.replace('intl', 'international').replace('none', 'base')}")
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = self.tokenize_fn(line)
        return self._lower(tokenized, self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        cls._check_tokenizers_validity(tokenize)
        fn = getattr(cls, f"_tokenize_{tokenize.replace('intl', 'international').replace('none', 'base')}")
        return cls._lower(fn(line), lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for pattern, repl in _13A_REGEX:
            line = pattern.sub(repl, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        out = []
        for char in line:
            if _is_chinese_char(char):
                out.append(f" {char} ")
            else:
                out.append(char)
        return cls._tokenize_regex("".join(out))

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        # Mirror mteval-v14's three substitutions using unicodedata categories:
        # split punctuation off non-digits, and isolate symbols.
        out = []
        chars = list(line)
        n = len(chars)
        for i, ch in enumerate(chars):
            cat = unicodedata.category(ch)
            if cat.startswith("P"):
                prev_is_digit = i > 0 and unicodedata.category(chars[i - 1]).startswith("N")
                next_is_digit = i + 1 < n and unicodedata.category(chars[i + 1]).startswith("N")
                if not prev_is_digit and not next_is_digit:
                    out.append(f" {ch} ")
                elif not prev_is_digit:
                    out.append(f" {ch}")
                elif not next_is_digit:
                    out.append(f"{ch} ")
                else:
                    out.append(ch)
            elif cat.startswith("S"):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return " ".join("".join(out).split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(
                f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize!r}."
                " (`ja-mecab`/`ko-mecab`/`flores*` need external tokenizer models unavailable in this build.)"
            )


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """SacreBLEU: BLEU with a standardized tokenizer, on ``device`` (``cuda`` unless given).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import sacre_bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    tokenize_fn = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)
    return _bleu_functional(preds, target, n_gram, smooth, weights, tokenize_fn, device)
