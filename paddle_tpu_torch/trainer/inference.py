"""Inference — the port of ``paddle_tpu/trainer/inference.py`` (successor of
``python/paddle/v2/inference.py``: a test-mode forward returning numpy
outputs).

It runs on ``cuda:0`` unless the caller passes ``device="cpu"``.  States
(the BN moving statistics) load from the parameters when they hold them,
else from the state specs' initial values, as the JAX package does."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.config.topology import Topology
from paddle_tpu_torch.core.lod import SequenceBatch, to_ragged
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.layers.base import LayerOutput
from paddle_tpu_torch.layers.data_type import InputType
from paddle_tpu_torch.reader.feeder import DataFeeder
from paddle_tpu_torch.trainer.step import build_forward


class Inference:
    def __init__(self, output_layer, parameters: Parameters,
                 strict: bool = False, device=None):
        """``strict=True`` refuses to run when a topology parameter has no
        value (an incomplete checkpoint would otherwise serve freshly
        initialized random weights); ``strict=False`` initializes what is
        missing, as a fresh ``parameters.create`` topology has it anyway."""
        if isinstance(output_layer, LayerOutput):
            output_layer = [output_layer]
        self.device = resolve_device(device)
        self.topology = Topology(output_layer)
        self.parameters = parameters
        for spec in self.topology.param_specs():
            self.parameters.add(spec)
        if strict:
            missing = self.parameters.uninitialized_names()
            if missing:
                raise ValueError(
                    "Inference(strict=True): parameters have no value for "
                    f"{sorted(missing)}; the checkpoint is incomplete for "
                    "this topology, refusing to serve random weights")
        self.parameters.init_missing()
        self.output_names = [o.name for o in output_layer]
        self._fwd = build_forward(self.topology, self.output_names)
        self.states = {
            s.name: (torch.as_tensor(self.parameters[s.name],
                                     device=self.device)
                     if s.name in self.parameters else
                     torch.full(s.shape, s.init_value,
                                dtype=s.dtype or torch.float32,
                                device=self.device))
            for s in self.topology.state_specs()}

    def _feeder(self, feeding) -> DataFeeder:
        types = {name: InputType(dim=n.attrs["dim"],
                                 seq_type=n.attrs["seq_type"],
                                 kind=n.attrs["data_type"])
                 for name, n in self.topology.data_layers().items()}
        return DataFeeder(types, feeding, device=self.device)

    def infer(self, input, feeding=None, field="value",
              batch_size: int | None = None):
        """The named layers' values for the samples of ``input``: a
        sequence output as a list of per-sample [T_i, ...] arrays, a dense
        one as one array (a list per output when there are several)."""
        feeder = self._feeder(feeding)
        params = {n: t.to(self.device)
                  for n, t in self.parameters.as_dict().items()}
        batches = [input] if batch_size is None else [
            input[i:i + batch_size] for i in range(0, len(input), batch_size)]
        outs: list[list] = [[] for _ in self.output_names]
        ragged = [False] * len(self.output_names)
        for b in batches:
            for i, r in enumerate(self._fwd(params, self.states, feeder(b))):
                if isinstance(r, SequenceBatch):
                    outs[i].extend(to_ragged(r))
                    ragged[i] = True
                else:
                    outs[i].append(r.detach().cpu().numpy())
        final = [chunks if ragged[i] else np.concatenate(chunks, axis=0)
                 for i, chunks in enumerate(outs)]
        return final[0] if len(final) == 1 else final


def infer(output_layer, parameters, input, feeding=None, field="value",
          device=None):
    """``paddle.infer``: one :class:`Inference` over ``input``."""
    return Inference(output_layer, parameters, device=device).infer(
        input, feeding=feeding, field=field)
