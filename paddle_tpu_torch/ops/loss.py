"""Cost functions of the port (``paddle_tpu/ops/loss.py``): per-example
costs [B]; the cost layers take the batch mean."""

from __future__ import annotations

import torch


def cross_entropy(probs: torch.Tensor, label: torch.Tensor,
                  eps: float = 1e-10) -> torch.Tensor:
    """-log(p[label] + eps) with integer labels (≅ MultiClassCrossEntropy).
    ``probs`` are post-softmax, as in the v2 cost contract."""
    p = torch.gather(probs, -1, label.long()[:, None])[:, 0]
    return -torch.log(p + eps)
