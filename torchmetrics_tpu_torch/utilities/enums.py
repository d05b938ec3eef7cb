"""String-valued enums used across the framework.

Parity target: reference ``torchmetrics/utilities/enums.py:20-150``.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional


class EnumStr(str, Enum):
    """Base class: case/sep-insensitive string enum with a helpful error."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "key") -> "EnumStr":
        try:
            norm = value.replace("-", "_").replace(" ", "_").lower()
            for member in cls:
                if member.value.replace("-", "_").replace(" ", "_").lower() == norm or member.name.lower() == norm:
                    return member
            raise KeyError(value)
        except (KeyError, AttributeError):
            valid = [m.lower() for m in cls.__members__]
            raise ValueError(
                f"Invalid {cls._name()}: expected one of {valid}, but got {value}."
            ) from None

    def __str__(self) -> str:
        return self.value.lower()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, str):
            norm = lambda s: s.replace("-", "_").replace(" ", "_").lower()  # noqa: E731
            return norm(self.value) == norm(other)
        return super().__eq__(other)

    def __hash__(self) -> int:
        return hash(self.value.replace("-", "_").replace(" ", "_").lower())


class DataType(EnumStr):
    """Type of an input tensor."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"

    @staticmethod
    def _name() -> str:
        return "Data type"


class AverageMethod(EnumStr):
    """Reduction applied over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"

    @staticmethod
    def _name() -> str:
        return "Average method"


class MDMCAverageMethod(EnumStr):
    """Reduction for multi-dim multi-class inputs."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


class ClassificationTask(EnumStr):
    """Classification task dispatch: binary / multiclass / multilabel."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"

    @staticmethod
    def _name() -> str:
        return "Classification"


class ClassificationTaskNoBinary(EnumStr):
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"

    @staticmethod
    def _name() -> str:
        return "Classification"


class ClassificationTaskNoMultilabel(EnumStr):
    BINARY = "binary"
    MULTICLASS = "multiclass"

    @staticmethod
    def _name() -> str:
        return "Classification"


def _check_task(task: str, enum_cls: type = ClassificationTask) -> EnumStr:
    return enum_cls.from_str(task) if isinstance(task, str) else task
