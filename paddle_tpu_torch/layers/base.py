"""Layer-graph core — the port of ``paddle_tpu/layers/base.py``.

Each layer constructor creates a :class:`LayerOutput` node carrying (a) a
config record (``attrs``, serialized by ``Topology.serialize`` byte for
byte as the JAX package does), (b) parameter/state specs and (c) a forward
function of torch tensors.  Backward is autograd over the forward.
A layer value is a tensor or a :class:`SequenceBatch` (padded data plus
lengths)."""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Any, Callable, Sequence

import torch

from paddle_tpu_torch.config import parse_state
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.enforce import enforce, error_scope
from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.core.parameters import ParamSpec


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Non-trainable persistent state (BN moving stats)."""

    name: str
    shape: tuple[int, ...]
    init_value: float = 0.0
    dtype: Any = None


class Context:
    """Per-step evaluation context: train/test mode and the step's seed
    (``core/rng.next_seed()`` in a train step; None where nothing may
    draw, as in ``test`` and ``infer``)."""

    def __init__(self, is_train: bool, seed: int | None = None):
        self.is_train = is_train
        self.seed = seed

    def generator_for(self, name: str, device) -> torch.Generator:
        """A fresh generator on ``device`` for layer ``name``, seeded from
        the step's seed and ``crc32(name)`` (not ``hash()``, which is
        salted per process), so a rerun of the step draws the same bits
        and two layers draw different ones (``key_for`` in the JAX
        package)."""
        enforce(self.seed is not None, f"layer {name!r} needs a step seed")
        gen = torch.Generator(device=device)
        return gen.manual_seed(rng.fold_in(self.seed,
                                           zlib.crc32(name.encode())))


_name_counters: dict[str, itertools.count] = {}

# every LayerOutput registers here at construction, in creation order (the
# JAX package's registry): ``recurrent_group`` finds the layers its step
# function built, including those reachable only through a memory link.
# The registry grows until ``reset_name_counters()``.
_layer_registry: list["LayerOutput"] = []


def layer_registry() -> list["LayerOutput"]:
    return list(_layer_registry)


def gen_name(layer_type: str) -> str:
    c = _name_counters.setdefault(layer_type, itertools.count())
    return f"__{layer_type}_{next(c)}__"


def reset_name_counters() -> None:
    """Restart auto layer names and drop config-level defaults, as every
    model build starts (≅ ``init_config_environment``)."""
    _name_counters.clear()
    _layer_registry.clear()
    parse_state.reset_defaults()


@dataclasses.dataclass(eq=False)
class LayerOutput:
    """A node in the layer DAG (≅ v2 ``LayerOutput`` over a LayerConfig)."""

    name: str
    layer_type: str
    size: int  # output feature size (v2 `size` semantics); 0 if n/a
    parents: tuple["LayerOutput", ...] = ()
    param_specs: tuple[ParamSpec, ...] = ()
    state_specs: tuple[StateSpec, ...] = ()
    fn: Callable | None = None  # (ctx, params, states, *parents) -> value | (value, states)
    attrs: dict = dataclasses.field(default_factory=dict)
    height: int = 0
    width: int = 0
    depth: int = 1  # channels for image layers

    def __post_init__(self):
        _layer_registry.append(self)

    def config_record(self) -> dict:
        """Serializable config (the ModelConfig-protostr analog)."""
        return {
            "name": self.name,
            "type": self.layer_type,
            "size": self.size,
            "inputs": [p.name for p in self.parents],
            "attrs": {k: v for k, v in sorted(self.attrs.items())
                      if _jsonable(v)},
            "params": [
                {"name": s.name, "shape": list(s.shape)}
                for s in self.param_specs
            ],
        }

    def __repr__(self):
        return f"LayerOutput({self.name}, type={self.layer_type}, size={self.size})"


def _jsonable(v) -> bool:
    if isinstance(v, (int, float, str, bool, type(None))):
        return True
    if isinstance(v, (list, tuple)):
        return all(_jsonable(x) for x in v)
    return False


def topo_sort(outputs: Sequence[LayerOutput]) -> list[LayerOutput]:
    """Deterministic post-order DFS over parents."""
    seen: dict[int, LayerOutput] = {}
    order: list[LayerOutput] = []

    def visit(node: LayerOutput, stack: set[int]):
        nid = id(node)
        if nid in seen:
            return
        enforce(nid not in stack, f"cycle in layer graph at {node.name!r}")
        stack.add(nid)
        for p in node.parents:
            visit(p, stack)
        stack.remove(nid)
        seen[nid] = node
        order.append(node)

    for out in outputs:
        visit(out, set())
    return order


def evaluate(nodes: Sequence[LayerOutput], ctx: Context,
             params: dict[str, torch.Tensor], states: dict[str, torch.Tensor],
             feed: dict[str, torch.Tensor]):
    """Evaluate the DAG once; returns ({layer_name: value}, new_states)."""
    values: dict[str, Any] = {}
    new_states = dict(states)
    for node in topo_sort(nodes):
        if node.fn is None and node.name in feed:
            # leaves only: data layers and the placeholders and memories a
            # recurrent_group feeds its step graph; a computed layer is
            # never shadowed by a feed key of the same name
            values[node.name] = feed[node.name]
            continue
        if node.layer_type == "data":
            enforce(node.name in feed,
                    f"missing feed for data layer {node.name!r}")
            values[node.name] = feed[node.name]
            continue
        parent_vals = [values[p.name] for p in node.parents]
        pvals = {s.name: params[s.name] for s in node.param_specs}
        svals = {s.name: new_states[s.name] for s in node.state_specs}
        with error_scope(node.name):
            result = node.fn(ctx, pvals, svals, *parent_vals)
        if (isinstance(result, tuple) and len(result) == 2
                and isinstance(result[1], dict)):
            value, supd = result
            new_states.update(supd)
        else:
            value = result
        values[node.name] = value
    return values, new_states


# -- value helpers shared by layer impls -----------------------------------


def is_sequence(v) -> bool:
    return isinstance(v, SequenceBatch)


def raw(v):
    """Underlying dense tensor of a layer value."""
    return v.data if isinstance(v, SequenceBatch) else v


def map_data(fn: Callable, v):
    """Apply fn to the dense data, keeping the sequence lengths: how
    per-step layers (fc, activations) act on sequence input."""
    if isinstance(v, SequenceBatch):
        return SequenceBatch(data=fn(v.data), length=v.length)
    return fn(v)
