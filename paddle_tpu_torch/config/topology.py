"""Topology — the compiled form of a layer DAG (the port of
``paddle_tpu/config/topology.py``).

- ``param_specs()`` / ``state_specs()`` — what ``parameters.create`` and
  the trainer materialize;
- ``forward(...)`` — one evaluation of the whole graph on torch tensors
  and sequence batches (autograd gives the backward);
- ``metrics()`` — the metrics its cost layers attach;
- ``serialize()`` / ``digest()`` — the stable JSON description, byte-equal
  to the JAX package's for the same graph."""

from __future__ import annotations

import hashlib
import json
from typing import Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.parameters import ParamSpec
from paddle_tpu_torch.layers.base import (Context, LayerOutput, StateSpec,
                                          evaluate, topo_sort)


class Topology:
    def __init__(self, outputs: LayerOutput | Sequence[LayerOutput],
                 extra_layers=None):
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs: list[LayerOutput] = list(outputs)
        self.extra_layers: list[LayerOutput] = list(extra_layers or [])
        self.nodes: list[LayerOutput] = topo_sort(self.outputs
                                                  + self.extra_layers)
        names = [n.name for n in self.nodes]
        enforce(len(names) == len(set(names)),
                "duplicate layer names in topology")

    # -- specs ---------------------------------------------------------------
    def data_layers(self) -> dict[str, LayerOutput]:
        """Input layers in graph order."""
        return {n.name: n for n in self.nodes if n.layer_type == "data"}

    def param_specs(self) -> list[ParamSpec]:
        seen: dict[str, ParamSpec] = {}
        for n in self.nodes:
            for s in n.param_specs:
                seen.setdefault(s.name, s)
        return list(seen.values())

    def state_specs(self) -> list[StateSpec]:
        seen: dict[str, StateSpec] = {}
        for n in self.nodes:
            for s in n.state_specs:
                seen.setdefault(s.name, s)
        return list(seen.values())

    def init_states(self, device=None) -> dict[str, torch.Tensor]:
        return {s.name: torch.full(s.shape, s.init_value,
                                   dtype=s.dtype or torch.float32,
                                   device=device)
                for s in self.state_specs()}

    def states_from_numpy(self, arrays, device=None) -> dict[str, torch.Tensor]:
        """This topology's states from arrays keyed by name (e.g. the JAX
        package's ``topo.init_states()`` as numpy), checked against the
        state specs: every state present, each with its spec's shape."""
        out = {}
        for s in self.state_specs():
            enforce(s.name in arrays, f"no value for state {s.name!r}")
            t = torch.tensor(np.asarray(arrays[s.name]),
                             dtype=s.dtype or torch.float32, device=device)
            enforce(tuple(t.shape) == s.shape,
                    f"state {s.name!r}: shape {tuple(t.shape)} != {s.shape}")
            out[s.name] = t
        return out

    def metrics(self) -> list[tuple[str, str, str, str]]:
        """(metric_kind, pred_layer, label_layer, tag) tuples attached by
        cost layers (``classification_cost``'s classification error).
        ``metric_runtime`` names where the runtime reads the values (the
        fused cost's logits companion, argmax-equal to the probs)."""
        out = []
        for n in self.nodes:
            m = n.attrs.get("metric_runtime") or n.attrs.get("metric")
            if m:
                out.append((m[0], m[1][0], m[1][1], n.name))
        return out

    # -- execution -------------------------------------------------------------
    def forward(self, params: dict[str, torch.Tensor],
                states: dict[str, torch.Tensor], feed: dict, is_train: bool,
                seed: int | None = None):
        """Evaluate every node; returns ({layer_name: value}, new_states).
        ``seed`` is the step's seed, from which layers that draw (dropout)
        make their generators."""
        return evaluate(self.nodes, Context(is_train, seed), params,
                        states, feed)

    # -- serialization --------------------------------------------------------
    def serialize(self) -> str:
        doc = {
            "layers": [n.config_record() for n in self.nodes],
            "input_layer_names": list(self.data_layers()),
            "output_layer_names": [o.name for o in self.outputs],
        }
        return json.dumps(doc, indent=2, sort_keys=True)

    def digest(self) -> str:
        return hashlib.sha256(self.serialize().encode()).hexdigest()[:16]
