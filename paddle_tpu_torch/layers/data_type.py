"""Input type declarations — the port of ``paddle_tpu/layers/data_type.py``
(the dense and integer, non-sequence types the image path feeds)."""

from __future__ import annotations

import dataclasses


class SeqType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class DataKind:
    DENSE = "dense"
    INTEGER = "integer"


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    seq_type: int = SeqType.NO_SEQUENCE
    kind: str = DataKind.DENSE
    height: int = 0
    width: int = 0
    channels: int = 0


def dense_vector(dim: int, height: int = 0, width: int = 0,
                 channels: int = 0) -> InputType:
    return InputType(dim, SeqType.NO_SEQUENCE, DataKind.DENSE, height, width,
                     channels)


def integer_value(value_range: int) -> InputType:
    return InputType(value_range, SeqType.NO_SEQUENCE, DataKind.INTEGER)
