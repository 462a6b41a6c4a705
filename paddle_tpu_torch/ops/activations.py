"""Activation functions of the port (the subset of
``paddle_tpu/ops/activations.py`` the v2 image path uses), keyed by the
reference's activation type strings."""

from __future__ import annotations

import torch


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


REGISTRY = {
    "": identity,
    "linear": identity,
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
