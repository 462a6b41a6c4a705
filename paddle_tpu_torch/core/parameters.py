"""Parameter store — the port of ``paddle_tpu/core/parameters.py``
(successor of ``python/paddle/v2/parameters.py``).

Values live as a flat ``{name: torch.Tensor}`` dict; the trainer moves
them to its device and writes the updated tensors back.  ``Parameters``
keeps the v2 contract: mapping interface, numpy in and out.
:meth:`Parameters.from_numpy` takes arrays keyed by name — e.g. the JAX
package's ``parameters.create(topo).as_dict()`` as numpy — so both
packages can start a trajectory from the same point.  The tar round trip
is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from paddle_tpu_torch.core import initializer as I
from paddle_tpu_torch.core.enforce import enforce


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Static description of one parameter (≅ ParameterConfig fields)."""

    name: str
    shape: tuple[int, ...]
    initializer: Callable  # (generator, shape, dtype) -> tensor
    dtype: Any = torch.float32
    is_static: bool = False
    learning_rate: float = 1.0  # per-param LR scale
    decay_rate: float | None = None  # per-param L2 override
    # per-param momentum (ParamAttr(momentum=...) or default_momentum());
    # overrides the optimizer-level coefficient
    momentum: float | None = None
    gradient_clipping_threshold: float | None = None
    sparse: bool = False
    sparsity_ratio: float | None = None
    attr: Any = None  # the originating ParamAttr

    def init(self, generator: torch.Generator) -> torch.Tensor:
        return self.initializer(generator, self.shape, self.dtype)


def default_generator(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


class Parameters:
    """v2-compatible parameter collection backed by torch tensors."""

    def __init__(self):
        self._specs: dict[str, ParamSpec] = {}
        self._values: dict[str, torch.Tensor] = {}

    # -- construction ---------------------------------------------------------
    def add(self, spec: ParamSpec) -> None:
        if spec.name in self._specs:
            # shared parameters (same ParamAttr name on two layers) are legal
            enforce(
                self._specs[spec.name].shape == spec.shape,
                f"shared parameter {spec.name!r} shape mismatch: "
                f"{self._specs[spec.name].shape} vs {spec.shape}",
            )
            return
        self._specs[spec.name] = spec

    def init_missing(self, generator: torch.Generator | None = None) -> None:
        """Materialize values for every spec without one, in spec order."""
        missing = [n for n in self._specs if n not in self._values]
        if not missing:
            return
        generator = generator if generator is not None else default_generator()
        for name in missing:
            self._values[name] = self._specs[name].init(generator)

    @classmethod
    def from_specs(cls, specs, generator=None) -> "Parameters":
        p = cls()
        for s in specs:
            p.add(s)
        p.init_missing(generator)
        return p

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "Parameters":
        """Parameters holding ``arrays`` ({name: array}) as tensors on
        ``device`` (default CPU).  Specs are bare (constant init), as for
        a loaded checkpoint; ``SGD`` adds the topology's specs on top and
        keeps these values."""
        p = cls()
        for name, arr in arrays.items():
            t = torch.tensor(np.asarray(arr), device=device)
            p._specs[name] = ParamSpec(name=name, shape=tuple(t.shape),
                                       initializer=I.constant(0.0),
                                       dtype=t.dtype)
            p._values[name] = t
        return p

    # -- mapping interface (v2 contract) --------------------------------------
    def names(self) -> list[str]:
        return list(self._specs)

    def keys(self) -> list[str]:
        return self.names()

    def has_key(self, key: str) -> bool:
        return key in self._specs

    def __contains__(self, key: str) -> bool:
        return key in self._specs

    def __iter__(self) -> Iterator[str]:
        return iter(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __getitem__(self, key: str) -> np.ndarray:
        """numpy copy of the value (reference: ``Parameters.get``)."""
        return self._values[key].detach().cpu().numpy()

    def __setitem__(self, key: str, value) -> None:
        spec = self._specs.get(key)
        enforce(spec is not None, f"no parameter {key!r}")
        value = torch.as_tensor(np.asarray(value), dtype=spec.dtype)
        enforce(tuple(value.shape) == spec.shape,
                f"parameter {key!r}: shape {tuple(value.shape)} != spec "
                f"{spec.shape}")
        self._values[key] = value

    def get(self, key: str) -> np.ndarray:
        return self[key]

    def set(self, key: str, value) -> None:
        self[key] = value

    def get_shape(self, key: str) -> tuple[int, ...]:
        return self._specs[key].shape

    def spec(self, key: str) -> ParamSpec:
        return self._specs[key]

    # -- tensor bridge (what the train step consumes/produces) ----------------
    def as_dict(self) -> dict[str, torch.Tensor]:
        return dict(self._values)

    def update_from(self, values: dict[str, torch.Tensor]) -> None:
        self._values.update(values)


def create(topology_or_specs, generator: torch.Generator | None = None
           ) -> Parameters:
    """``paddle.parameters.create(...)`` v2 entry point: a ``Topology``, a
    cost layer (or a list of them, wrapped in a ``Topology`` as v2 does),
    or a list of specs.  Values are drawn from ``generator`` (default:
    a generator seeded 0)."""
    from paddle_tpu_torch.layers.base import LayerOutput

    if isinstance(topology_or_specs, LayerOutput) or (
            isinstance(topology_or_specs, (list, tuple)) and topology_or_specs
            and isinstance(topology_or_specs[0], LayerOutput)):
        from paddle_tpu_torch.config.topology import Topology

        topology_or_specs = Topology(topology_or_specs)
    if hasattr(topology_or_specs, "param_specs"):
        specs = topology_or_specs.param_specs()
    else:
        specs = list(topology_or_specs)
    return Parameters.from_specs(specs, generator)
