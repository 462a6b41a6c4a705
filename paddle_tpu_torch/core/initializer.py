"""Parameter initializers — the port of ``paddle_tpu/core/initializer.py``.

Each initializer is ``init(generator, shape, dtype) -> tensor`` on the
CPU, drawing from an explicit ``torch.Generator`` (the JAX package draws
from a key).  The two frameworks give different numbers from the same
seed; tests carry values across by name instead (``Parameters.from_numpy``)."""

from __future__ import annotations

import math

import torch


def constant(value: float = 0.0):
    def init(generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype)

    return init


def uniform(low: float = -1.0, high: float = 1.0):
    def init(generator, shape, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return low + (high - low) * u

    return init


def normal(mean: float = 0.0, std: float = 1.0):
    def init(generator, shape, dtype=torch.float32):
        return mean + std * torch.randn(tuple(shape), generator=generator,
                                        dtype=dtype)

    return init


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [H, W, Cin, Cout] (NHWC-native layout)
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def xavier(uniform_dist: bool = True, scale: float = 1.0):
    """Glorot init (Fluid XavierInitializer)."""

    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        if uniform_dist:
            lim = scale * math.sqrt(6.0 / (fan_in + fan_out))
            return uniform(-lim, lim)(generator, shape, dtype)
        std = scale * math.sqrt(2.0 / (fan_in + fan_out))
        return normal(0.0, std)(generator, shape, dtype)

    return init


def msra(uniform_dist: bool = False, scale: float = 1.0):
    """He init (Fluid MSRAInitializer) — the default of ReLU convs."""

    def init(generator, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        if uniform_dist:
            lim = scale * math.sqrt(6.0 / fan_in)
            return uniform(-lim, lim)(generator, shape, dtype)
        std = scale * math.sqrt(2.0 / fan_in)
        return normal(0.0, std)(generator, shape, dtype)

    return init


def paddle_default(initial_mean: float = 0.0, initial_std: float | None = None):
    """The reference's default: N(mean, std) with std = 1/sqrt(width) when
    unspecified."""

    def init(generator, shape, dtype=torch.float32):
        std = initial_std
        if std is None:
            width = shape[0] if shape else 1
            std = 1.0 / math.sqrt(max(width, 1))
        return normal(initial_mean, std)(generator, shape, dtype)

    return init
