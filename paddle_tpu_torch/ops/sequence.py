"""Sequence ops of the port (``paddle_tpu/ops/sequence.py``: the
non-nested ``seq_last`` and ``seq_first``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.lod import SequenceBatch


def seq_last(x: SequenceBatch) -> torch.Tensor:
    return x.last_step()


def seq_first(x: SequenceBatch) -> torch.Tensor:
    return x.first_step()
