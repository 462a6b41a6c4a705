"""Dtype policy — float32 at full precision.

The JAX package requests ``Precision.HIGHEST`` for f32 operands, so an
f32 product is a true f32 product (README "Mixed precision as policy").
On the card the same policy means TF32 off for matmuls AND for cuDNN:
PyTorch leaves cuDNN convolutions in TF32 by default, which keeps about
three decimal digits.  bf16 compute is later work; until then the only
float dtype the port serves is float32."""

from __future__ import annotations

import torch

_BY_NAME = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}


def set_f32_policy() -> None:
    """Full-precision, reproducible f32 on the card: TF32 off in both the
    cuBLAS and the cuDNN paths, and cuDNN restricted to deterministic
    algorithms (set explicitly, not left to defaults).  The port's own
    kernels are deterministic; with cuDNN's conv backward deterministic
    too, a training run on the card repeats bit for bit, as the JAX
    package's do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` upcast to float32, or as it is when it is wider: the f32
    accumulations of the port never narrow a float64 input, so the same
    code runs a double-precision witness step on the CPU."""
    return x if x.dtype == torch.float64 else x.float()


def from_name(name: str) -> torch.dtype:
    """A dtype name as the JAX package stores it ("float32") -> torch."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_BY_NAME)}") from None
