"""Plain tensor ops of the transformer block (the port's side of
``paddle_tpu/ops/nn.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Single-pass LN, the same form as ``paddle_tpu.ops.nn.layer_norm``:
    one f32 upcast, var = E[x^2] - E[x]^2 clamped at 0 (f32 rounding can
    leave it slightly negative for a constant row with a large mean).
    ``F.layer_norm`` computes the variance in two passes and rounds
    differently, so it is not used."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    msq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(msq - mean * mean, min=0.0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation.  PyTorch's
    default (erf) differs by about 1e-3, enough to flip greedy tokens."""
    return F.gelu(x, approximate="tanh")
