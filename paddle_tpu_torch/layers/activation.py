"""Activation objects — the port of ``paddle_tpu/layers/activation.py``
(``ReluActivation()`` etc. passed as ``act=`` to layer constructors)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from paddle_tpu_torch.ops import activations as _ops


@dataclasses.dataclass(frozen=True)
class BaseActivation:
    name: str
    fn: Callable

    def __call__(self, x):
        return self.fn(x)


def _mk(name: str) -> Callable[[], BaseActivation]:
    def ctor():
        return BaseActivation(name=name, fn=_ops.get(name))

    ctor.__name__ = name
    return ctor


LinearActivation = _mk("")  # the reference's IdentityActivation proto name
TanhActivation = _mk("tanh")  # fc's default
ReluActivation = _mk("relu")
SoftmaxActivation = _mk("softmax")


def get(act):
    """None -> linear; str -> registry; object -> itself."""
    if act is None:
        return BaseActivation("", _ops.identity)
    if isinstance(act, str):
        return BaseActivation(act, _ops.get(act))
    return act
