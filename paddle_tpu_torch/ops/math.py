"""Dense math of the port (``paddle_tpu/ops/math.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import at_least_f32, cast_for_matmul


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 accumulator, as the JAX package's ``matmul``
    (``preferred_element_type=f32``): f32 operands at full precision (TF32
    off), bf16 operands on the tensor cores with their split-K partials
    reduced in f32 (``core/dtype.set_policy``), rounded once to bf16.
    Mixed operands resolve by ``cast_for_matmul``, and the result takes
    their promoted dtype; where that is wider than the resolved one (a
    bf16 x f32 pair), the f32 accumulator reaches it unrounded, as in
    JAX: the bf16 operands go in as f32, whose products are exact."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = cast_for_matmul(a, b)
    if a.dtype != out_dtype:
        a, b = at_least_f32(a), at_least_f32(b)
    return torch.matmul(a, b).to(out_dtype)
