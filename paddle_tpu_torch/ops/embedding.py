"""Embedding lookup of the port (``paddle_tpu/ops/embedding.py``).

A 2-D table goes through ``kernels/embedding.fused_embedding_lookup``, the
route the JAX package takes on the TPU: on the card the gather and
scatter-add kernels, on the CPU their plain twins, so both devices give
one semantics (ids clamped to ``[0, V)`` on the forward, no gradient for
ids outside it or for ``padding_idx`` rows)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.embedding import fused_embedding_lookup


def lookup(table: torch.Tensor, ids: torch.Tensor,
           padding_idx: int | None = None) -> torch.Tensor:
    """table [V, D] gathered by integer ids of any shape -> [..., D]."""
    return fused_embedding_lookup(table, ids, padding_idx)
