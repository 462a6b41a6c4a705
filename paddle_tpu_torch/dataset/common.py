"""Dataset helpers — the port of ``paddle_tpu/dataset/common.py``'s
:func:`synthetic_rng` (the download cache is not ported: the port's
readers are the seeded synthetic ones)."""

from __future__ import annotations

import zlib

import numpy as np


def synthetic_rng(name: str, split: str) -> np.random.Generator:
    """Deterministic per-(dataset, split) generator so train and test
    differ but every run sees the same data (crc32, not ``hash()``, which
    is salted per process)."""
    seed = zlib.crc32(f"{name}/{split}".encode()) % (2**31)
    return np.random.default_rng(seed)
