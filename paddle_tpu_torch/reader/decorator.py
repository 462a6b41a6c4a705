"""Reader decorators — the port of ``batch``, ``firstn`` and ``shuffle``
from ``paddle_tpu/reader/decorator.py`` (≅ ``python/paddle/v2/reader``).
A reader is a zero-argument callable returning an iterator of samples."""

from __future__ import annotations

import itertools
import random as _random


def shuffle(reader, buf_size: int):
    """Buffered shuffle (fill ``buf_size`` samples, shuffle, drain) with
    Python's global ``random`` stream, as the reference does."""

    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled


def firstn(reader, n: int):
    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists (≅ paddle.batch); the tail partial batch is
    kept unless ``drop_last``."""

    def batch_reader():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
