"""Cost functions of the port (``paddle_tpu/ops/loss.py``): per-example
costs [B]; the cost layers take the batch mean."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import at_least_f32


def cross_entropy(probs: torch.Tensor, label: torch.Tensor,
                  eps: float = 1e-10) -> torch.Tensor:
    """-log(p[label] + eps) with integer labels (≅ MultiClassCrossEntropy).
    ``probs`` are post-softmax, as in the v2 cost contract."""
    p = torch.gather(probs, -1, label.long()[:, None])[:, 0]
    return -torch.log(p + eps)


def cross_entropy_from_logits(logits: torch.Tensor,
                              label: torch.Tensor) -> torch.Tensor:
    """lse(logits) - logits[label] per row, in f32 (the fused-from-logits
    cost of ``classification_cost``; equal to -log(softmax[label]) up to
    round-off and the +1e-10 guard).  A float64 input stays float64."""
    logits = at_least_f32(logits)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, label.long().reshape(-1, 1))[:, 0]
    return lse - tgt
