"""Dense math of the port (``paddle_tpu/ops/math.py``)."""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 at full precision (TF32 off by the port's dtype
    policy): the JAX package asks for ``Precision.HIGHEST`` here."""
    return torch.matmul(a, b)
