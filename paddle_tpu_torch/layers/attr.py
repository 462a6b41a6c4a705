"""Attribute objects — the port of ``paddle_tpu/layers/attr.py``
(ParameterAttribute / ExtraLayerAttribute): per-parameter init, LR scale,
decay and momentum, and per-layer knobs.  Fields the JAX package keeps
only for its proto output or its mesh (``l1_rate``, ``sharding``,
``device``) are not accepted."""

from __future__ import annotations

import dataclasses
from typing import Callable

from paddle_tpu_torch.config import parse_state
from paddle_tpu_torch.core import initializer as I


@dataclasses.dataclass
class ParamAttr:
    """≅ ParameterAttribute: controls one parameter's init/decay/LR."""

    name: str | None = None  # share parameters by giving two layers one name
    is_static: bool = False
    initial_std: float | None = None
    initial_mean: float | None = None
    initial_max: float | None = None  # uniform bounds
    initial_min: float | None = None
    learning_rate: float | None = None  # None => global LR (scale 1)
    l2_rate: float | None = None  # per-param decay override
    momentum: float | None = None  # per-param momentum
    sparse_update: bool = False
    sparsity_ratio: float | None = None
    gradient_clipping_threshold: float | None = None
    initializer: Callable | None = None  # direct override

    def make_initializer(self, default: Callable) -> Callable:
        if self.initializer is not None:
            return self.initializer
        if self.initial_max is not None or self.initial_min is not None:
            lo = self.initial_min if self.initial_min is not None else -1.0
            hi = self.initial_max if self.initial_max is not None else 1.0
            return I.uniform(lo, hi)
        # config-level defaults (default_initial_std() etc.), read when the
        # layer is built
        gd = parse_state.G_DEFAULTS
        mean = (self.initial_mean if self.initial_mean is not None
                else gd["initial_mean"])
        std = (self.initial_std if self.initial_std is not None
               else gd["initial_std"])
        if gd["initial_strategy"] == 1:
            m = 0.0 if mean is None else mean
            s_ = 0.01 if std is None else std
            return I.uniform(m - s_, m + s_)
        if std is not None or mean is not None:
            return I.paddle_default(mean or 0.0, std)
        return default


ParameterAttribute = ParamAttr
Param = ParamAttr


@dataclasses.dataclass
class ExtraAttr:
    """≅ ExtraLayerAttribute: layer-level knobs.  ``drop_rate`` folds
    dropout into the layer (``layers/api._maybe_dropout``); a layer given
    ``error_clipping_threshold`` raises (not ported yet)."""

    drop_rate: float = 0.0
    error_clipping_threshold: float | None = None


ExtraLayerAttribute = ExtraAttr
Extra = ExtraAttr


def param_attr_or_default(attr: ParamAttr | None) -> ParamAttr:
    return attr if attr is not None else ParamAttr()
