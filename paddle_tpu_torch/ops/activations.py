"""Activation functions of the port (the subset of
``paddle_tpu/ops/activations.py`` the v2 image and text paths use), keyed
by the reference's activation type strings."""

from __future__ import annotations

import torch


def identity(x):
    return x


def sigmoid(x):
    return torch.sigmoid(x)


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, axis: int = -1):
    """``jax.nn.softmax``.  A bf16 (or f16) input runs its op sequence in
    the input's dtype, rounding where the JAX package rounds: exp of the
    shifted input, the sum (accumulated in f32), the division;
    ``torch.softmax`` would compute in f32 and round once."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.softmax(x, dim=axis)
    e = torch.exp(x - x.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True)


REGISTRY = {
    "": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "relu": relu,
    "tanh": tanh,
    "softmax": softmax,
}


def get(name: str):
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"activation {name!r} is not ported; known: "
                         f"{sorted(REGISTRY)}") from None
