"""Pooling-type objects — the port of ``paddle_tpu/layers/pooling.py``
(MaxPooling/AvgPooling passed as ``pool_type=``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BasePoolingType:
    name: str


class MaxPooling(BasePoolingType):
    def __init__(self):
        super().__init__("max")


class AvgPooling(BasePoolingType):
    def __init__(self):
        super().__init__("average")


def get(p) -> str:
    if p is None:
        return "max"
    if isinstance(p, str):
        return p
    return p.name
