"""Exact attention — the plain path of ``paddle_tpu/ops/attention.py``.

Shapes: [B, T, H, D] (batch, time, heads, head_dim) throughout."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import NEG_INF


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mask: torch.Tensor | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D], mask broadcastable to
    [B, H, Tq, Tk] bool -> [B, Tq, H, D].  Masked scores take the finite
    ``NEG_INF``, as in the JAX package."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, scores.new_tensor(NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_mask(t_q: int, t_k: int, device=None) -> torch.Tensor:
    """[1, 1, Tq, Tk] bool: query i sees keys 0..i."""
    qi = torch.arange(t_q, device=device)
    ki = torch.arange(t_k, device=device)
    return (qi[:, None] >= ki[None, :])[None, None]
